"""Multi-scale multi-view bilinear sampling over y-fold and pair-mode tables.

Counterpart of ``sparsebev_tpu/ops/msmv_sampling.py``, main-path subset:
``PackedFeatures`` and its (b, t, n, h, g) row order, the grouped pack
(y-fold and pair levels), the streaming table ring, ``table_acc_dtype``, the
separable slot weights, the readable oracle ``msmv_sampling_reference`` and
the production op ``msmv_sampling``.

``msmv_sampling`` holds the second CUDA kernel of the port
(``csrc/msmv_sample.cu``): it replaces the JAX package's XLA window gather
plus tap fold (``_yfold_forward`` :1011, ``_fold_window_taps`` :893,
``_gmajor_forward`` :910) with one kernel that computes the point geometry,
reads each point's windows per level, weights and sums them.
:func:`msmv_sampling_plain` is its plain PyTorch version and follows the JAX
order of operations (see ``table_acc_dtype``).

Semantics (as in the JAX module): locations are ``[Q, S, P, 3]`` with x, y in
[0, 1] (pixel = loc * (size - 1)) and the view normalized by 1 / (N - 1)
(view = clip(round(v * (N - 1)))); scale weights ``[Q, S, P, L]``; output
``[Q, S, P, C]`` = sum_l w_l * bilinear(level l) with zero padding per tap.

Table modes, per level (``table_yfold``): a y-fold level's row ``y`` holds
``feat[y] ‖ feat[y+1]`` (2C wide, one window read per point); a pair level's
row holds ``feat[y]`` alone (C wide, 1x feature memory, two row reads per
point). Group-split flags (``table_gsplit``) do not change the tables: the
port keeps one table per level. They select the ACCUMULATION ORDER of pair
levels, which is the one place where the JAX package's group-major forward
(taken when any level is group-split) differs from the unsplit one in bf16:
``_gmajor_forward`` adds a pair level's two y taps in fp32 and rounds once
into the accumulator; ``_yfold_forward`` rounds and adds each y tap on its
own. For y-fold levels the two orders are the same, bit for bit.

bf16 bits: the port gives the bits XLA gives on the CPU under ``jax.jit``
(the way the JAX package runs), in both orders. There XLA's excess-precision
rewrite drops exactly one rounding of the written JAX code: a bf16 tap times
its bf16 weight is kept in fp32 (where it is exact) instead of being rounded
to bf16. The weights, each level's sum and the bf16 accumulator are rounded
as written. (Run op by op, outside ``jit``, JAX rounds the products too.)

The hybrid entry point (``set_sampling_impl("hybrid")``, JAX :51-64):
:func:`pack_mlvl_feats` then keeps every level of at most
``_MXU_LEVEL_MAX_ELEMS`` elements per sample as a bf16 ``[B, N*H, W*C]``
table (``PackedFeatures.mxu_tables``), and :func:`msmv_sampling` given such
tables takes slice-major points and samples those levels with one launch of
``msmv_onehot.onehot_sample_levels`` (``csrc/msmv_onehot.cu``), the others
with the y-fold kernel. As in the JAX package, the model path never gets there:
``projection.sampling_4d`` warns and packs without MXU tables.

Gradients (training): :func:`msmv_sampling` is differentiable in the tables,
the x / y of the locations and the scale weights (the view coordinate goes
through ``round`` and gets zero). As the JAX ``custom_vjp``
(``_msmv_yfold_bwd`` :857) the backward is NOT the derivative of the window
forward's rounded arithmetic but the VJP of the all-fp32 half-row primal
``_msmv_halfrow`` (:775), ported as :func:`msmv_halfrow_plain`. On CUDA
tensors it is one launch of ``csrc/msmv_sample_bwd.cu``
(:func:`msmv_sampling_backward`); :func:`msmv_sampling_backward_plain`
(autograd of the half-row primal over the tables in their own dtype) is its
plain version. Both round the table gradient as the JAX VJP does: every
contribution is rounded to the table dtype and added in it, one rounding per
add (the plain version in index order, which gives JAX's bits on the CPU;
the kernel in the order its reductions land). Tables packed by
:func:`pack_mlvl_feats_grouped` carry a ``TableGrad`` per level
(``PackedFeatures.table_grads``): every sampling backward of a backward pass
adds into that one buffer and the pack's adjoint reads it
(``ops/msmv_pack.py``).

fp8 rings (``table_fp8``, streaming only, as in JAX): :func:`ring_init` takes
a dtype a level, :func:`ring_update` writes an e4m3 level as the JAX ring does
(clipped to +-448 in fp32, then cast with round-to-nearest-even), and the
folds upcast an e4m3 gather to bf16 before its weights are cast to its dtype,
so an e4m3 level samples as a bf16 level holding the same values. With level
0 in e4m3 the output and accumulator are fp32 (``table_acc_dtype``) and each
level's fold adds unrounded. On CUDA tensors the sampling kernel reads e4m3
levels beside bf16 ones; the sampling backward takes no e4m3 table.

Not in this slice: chunk-split rings (``table_split > 1``); configs that ask
for them are refused by ``models/head.py::check_table_options``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..kernels import build
from .msmv_onehot import LANE_BYTES as _LANE_BYTES
from .msmv_onehot import MAX_LEVELS as _MAX_LEVELS
from .msmv_onehot import (_clamp_pixels, _view_index, lanes_per_point,
                          onehot_sample_levels)
from .msmv_pack import TableGrad, pack_level, pack_level_pair

# the fp8 ring dtype and its largest finite value
E4M3 = torch.float8_e4m3fn
E4M3_MAX = float(torch.finfo(E4M3).max)

# sampling implementation: "xla" (y-fold tables for every level; the
# default) or "hybrid" (pack_mlvl_feats keeps the small levels as bf16
# tables for the one-hot sampler; inference only)
_SAMPLING_IMPL = "xla"
# a level goes to the one-hot sampler when N*H*W*C is at most this
_MXU_LEVEL_MAX_ELEMS = 2_200_000


def set_sampling_impl(name: str) -> None:
    global _SAMPLING_IMPL
    if name not in ("xla", "hybrid"):
        raise ValueError(f"unknown sampling impl {name!r}")
    _SAMPLING_IMPL = name


def get_sampling_impl() -> str:
    return _SAMPLING_IMPL


def _per_level(spec, n, name):
    """A bool (or int) spec broadcast to ``n`` levels, or a per-level
    sequence checked for length."""
    if isinstance(spec, (bool, int)):
        return (bool(spec),) * n
    spec = tuple(bool(v) for v in spec)
    if len(spec) != n:
        raise ValueError(f"per-level {name} sequence has {len(spec)} entries "
                         f"for {n} feature levels")
    return spec


class PackedFeatures:
    """Per-level row tables: y-fold ``[rows, W_l + 1, 2C]`` or pair
    ``[rows, W_l + 1, C]`` (``yfold``, a bool or one flag per level).

    A y-fold row ``y`` holds ``feat[y] ‖ feat[y+1]`` on the channel axis
    (``feat[H]`` reads as zeros) plus one zero guard column, so one
    (2 columns x 2C) window holds all four bilinear taps of a point. A pair
    row holds ``feat[y]`` plus the guard column; a point reads rows ``y`` and
    ``min(y+1, H-1)``.

    Rows are ordered (b, t, n, h, g): a slice index ``s`` in [0, batch) is
    ``(bt = s // G, g = s % G)``. ``slice_map`` (optional int ``[batch]``)
    maps logical slices to physical ones (the streaming ring holds frames in
    slot order); it is applied per slice, before any per-point work.
    ``gsplit`` (a bool or one flag per level) marks the group-split levels of
    the JAX layout; here it only selects the pair-level accumulation order
    (see the module docstring). ``tables`` may hold ``None`` entries in a
    geometry-only copy (:meth:`meta`) and for the levels that
    ``mxu_tables`` (hybrid impl only, :func:`pack_mlvl_feats`) holds as bf16
    ``[B, N*H, W*C]`` tables. ``table_grads`` (optional, one
    :class:`~.msmv_pack.TableGrad` a level) is where the sampling backward
    sums the packed tables' gradients for the packs' adjoints.
    """

    def __init__(self, tables, batch: int, num_views: int, level_shapes,
                 channels: int, num_groups: int = 1,
                 slice_map: Optional[torch.Tensor] = None, yfold=True,
                 gsplit=False, mxu_tables=(), table_grads=None):
        self.tables = tuple(tables)
        self.mxu_tables = tuple(mxu_tables)
        self.table_grads = (None if table_grads is None
                            else tuple(table_grads))
        self.batch = batch
        self.num_views = num_views
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.channels = channels
        self.num_groups = num_groups
        self.slice_map = slice_map
        n = len(self.level_shapes)
        self.yfold = _per_level(yfold, n, "yfold")
        self.gsplit = _per_level(gsplit, n, "gsplit")
        if any(gs and not yf for gs, yf in zip(self.gsplit, self.yfold)):
            raise ValueError("table_gsplit requires a yfold level")

    def row_index(self, slice_idx, view, row_y, height):
        """Flat table row for (slice, view, y-row) under the row order above."""
        g = self.num_groups
        if g == 1:
            return (slice_idx * self.num_views + view) * height + row_y
        bt = slice_idx // g
        gi = slice_idx % g
        return ((bt * self.num_views + view) * height + row_y) * g + gi

    def row_width(self, level: int) -> int:
        """Channels of one table row of ``level``: 2C y-fold, C pair."""
        return (2 if self.yfold[level] else 1) * self.channels

    def replace(self, **changes) -> "PackedFeatures":
        """A copy with the constructor arguments in ``changes`` replaced and
        every other one, ``table_grads`` included, carried over."""
        args = dict(tables=self.tables, batch=self.batch,
                    num_views=self.num_views, level_shapes=self.level_shapes,
                    channels=self.channels, num_groups=self.num_groups,
                    slice_map=self.slice_map, yfold=self.yfold,
                    gsplit=self.gsplit, mxu_tables=self.mxu_tables,
                    table_grads=self.table_grads)
        args.update(changes)
        return PackedFeatures(**args)

    def meta(self, gsplit=None) -> "PackedFeatures":
        """Geometry-only copy (no table buffers). ``gsplit`` replaces the
        group-split flags (the streaming ring's ``table_gsplit``)."""
        return PackedFeatures((None,) * len(self.tables), self.batch,
                              self.num_views, self.level_shapes,
                              self.channels, self.num_groups,
                              yfold=self.yfold,
                              gsplit=self.gsplit if gsplit is None else gsplit)


def pack_mlvl_feats(mlvl_feats: Sequence[torch.Tensor]) -> PackedFeatures:
    """Pack pyramids ``[B, N, H, W, C]`` (slice-major, one group) for
    :func:`msmv_sampling`: y-fold tables ``[B*N*H, W+1, 2C]`` (one
    :func:`~.msmv_pack.pack_level` call each, G = 1). Under the "hybrid" impl
    a level with ``N*H*W*C <= _MXU_LEVEL_MAX_ELEMS`` is kept instead as a bf16
    ``[B, N*H, W*C]`` table for the one-hot sampler (JAX :163-183)."""
    b, n = mlvl_feats[0].shape[0], mlvl_feats[0].shape[1]
    c = mlvl_feats[0].shape[-1]
    hybrid = _SAMPLING_IMPL == "hybrid"
    tables, shapes, mxu = [], [], []
    for feat in mlvl_feats:
        h, w = feat.shape[2], feat.shape[3]
        if hybrid and n * h * w * c <= _MXU_LEVEL_MAX_ELEMS:
            mxu.append(feat.reshape(b, n * h, w * c).to(torch.bfloat16))
            tables.append(None)
        else:
            mxu.append(None)
            t = pack_level(feat.reshape(b * n, h, w, c), 1)
            tables.append(t.reshape(b * n * h, w + 1, 2 * c))
        shapes.append((h, w))
    return PackedFeatures(tables, b, n, shapes, c, mxu_tables=mxu)


def pack_mlvl_feats_grouped(mlvl_feats: Sequence[torch.Tensor],
                            num_views: int, num_groups: int,
                            yfold=True, gsplit=False) -> PackedFeatures:
    """Pack per-frame pyramids ``[B, T*N, H, W, C]`` into grouped tables,
    row order (b, t, n, h, g): y-fold levels as ``[B*T*N*H*G, W+1, 2Cg]``
    (one :func:`~.msmv_pack.pack_level` call each), pair levels
    (``yfold`` False for the level) as ``[B*T*N*H*G, W+1, Cg]`` (one
    :func:`~.msmv_pack.pack_level_pair` call each). ``gsplit`` (the JAX
    pack's per-group chunk buffers, the training configs'
    ``table_gsplit_pack``) keeps one table a level here and only selects the
    accumulation order, as the ring's flags do. Differentiable: the packs
    are autograd Functions; tables packed in a graph get a ``TableGrad``
    a level that the sampling backward sums the table gradient into."""
    n, g = num_views, num_groups
    b, tn = mlvl_feats[0].shape[0], mlvl_feats[0].shape[1]
    t = tn // n
    c = mlvl_feats[0].shape[-1]
    cg = c // g
    yfold = _per_level(yfold, len(mlvl_feats), "yfold")
    tables, shapes, grads = [], [], []
    for feat, yf in zip(mlvl_feats, yfold):
        h, w = feat.shape[2], feat.shape[3]
        pack = pack_level if yf else pack_level_pair
        grads.append(TableGrad())
        t2 = pack(feat.reshape(b * t * n, h, w, c), g, grads[-1])
        tables.append(t2.reshape(b * t * n * h * g, w + 1, t2.shape[-1]))
        shapes.append((h, w))
    in_graph = all(t.requires_grad for t in tables)
    return PackedFeatures(tables, b * t * g, n, shapes, cg, num_groups=g,
                          yfold=yfold, gsplit=gsplit,
                          table_grads=grads if in_graph else None)


def ring_init(frame_packed: PackedFeatures, num_slots: int, dtypes=None):
    """Allocate an all-zero table ring with ``num_slots`` frame slots: a
    per-level tuple of ``[num_slots*N*H*G, W+1, row]`` tensors (row = 2Cg
    for y-fold levels, Cg for pair levels) on the single-frame
    ``frame_packed`` tables' device. ``dtypes``: one dtype for every level
    or one a level (``inference.ring_table_dtypes``: e4m3 for a
    ``table_fp8`` level); None, the frame tables' dtype."""
    t0 = frame_packed.tables[0]
    n = len(frame_packed.level_shapes)
    if dtypes is None or isinstance(dtypes, torch.dtype):
        dtypes = (dtypes or t0.dtype,) * n
    if len(dtypes) != n:
        raise ValueError(f"per-level dtype sequence has {len(dtypes)} "
                         f"entries for {n} feature levels (check table_fp8 "
                         "in the config)")
    rows = frame_packed.num_views * frame_packed.num_groups
    return tuple(torch.zeros((num_slots * rows * h, w + 1,
                              frame_packed.row_width(lvl)),
                             dtype=dt, device=t0.device)
                 for lvl, ((h, w), dt) in enumerate(
                     zip(frame_packed.level_shapes, dtypes)))


def ring_update(ring_tables, frame_packed: PackedFeatures, slot: int):
    """Write one frame's tables into ring slot ``slot``, IN PLACE (the JAX
    version returns an updated copy; the in-place copy saves the ring's
    memory twice over). An e4m3 level gets the frame's values clipped to
    +-``E4M3_MAX`` in fp32 and cast with round-to-nearest-even, as the JAX
    ring writes it (``sparsebev_tpu/ops/msmv_sampling.py:421-429``): e4m3
    has no infinity, and the clip keeps an outlier from depending on how a
    library casts out-of-range values. Returns ``ring_tables``."""
    if frame_packed.batch != frame_packed.num_groups:
        raise ValueError("ring_update expects single-frame, B=1 packed tables")
    for ring, frame in zip(ring_tables, frame_packed.tables):
        rows = frame.shape[0]
        if ring.shape[0] % rows or ring.shape[1:] != frame.shape[1:]:
            raise ValueError("frame tables do not tile the ring")
        if ring.dtype == E4M3 and frame.dtype != E4M3:
            frame = frame.float().clamp_(-E4M3_MAX, E4M3_MAX)
        ring[slot * rows:(slot + 1) * rows].copy_(frame)
    return ring_tables


def ring_packed(ring_tables, slots_of_t: torch.Tensor, num_frames: int,
                frame_packed_meta: PackedFeatures) -> PackedFeatures:
    """View a table ring as PackedFeatures for the decoder.

    ``slots_of_t``: int ``[T]`` — the ring slot of each logical frame
    (0 = newest), carried as ``slice_map [T*G]``. The table modes and
    group-split flags come from ``frame_packed_meta``."""
    g = frame_packed_meta.num_groups
    slots_of_t = slots_of_t.to(torch.int64)
    groups = torch.arange(g, dtype=torch.int64, device=slots_of_t.device)
    slice_map = (slots_of_t[:, None] * g + groups[None]).reshape(
        num_frames * g)
    return PackedFeatures(ring_tables, num_frames * g,
                          frame_packed_meta.num_views,
                          frame_packed_meta.level_shapes,
                          frame_packed_meta.channels, num_groups=g,
                          slice_map=slice_map, yfold=frame_packed_meta.yfold,
                          gsplit=frame_packed_meta.gsplit)


def table_acc_dtype(packed: PackedFeatures) -> torch.dtype:
    """Output/accumulator dtype of the sampling op: level 0's table dtype
    for bf16/fp32 tables (each level's tap contraction still reduces in
    fp32), fp32 otherwise (an e4m3 level 0: every level's fold then adds
    unrounded)."""
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


def _gather(flat, col):
    """``flat[col]``; an e4m3 table's rows are gathered as bytes (indexing
    takes every dtype that way on every device)."""
    if flat.dtype == E4M3:
        return flat.view(torch.uint8)[col].view(E4M3)
    return flat[col]


def _fold_window_taps(g0, g1, fxa, fxb, fya, fyb, c):
    """y-fold window contraction: the window's two columns ``g0``/``g1``
    ``[K, 2C]`` -> fp32 ``[K, C]``. The x weights are rounded to the table
    dtype; each tap times its x weight is taken in fp32 (exact for bf16
    operands: XLA under ``jit`` drops the bf16 rounding of these products,
    see the module docstring), the two x taps add in fp32 and the y/level
    weights fold in fp32 (``_fold_window_taps`` :893)."""
    if g0.dtype == E4M3:        # upcast first: the weights round to bf16
        g0, g1 = g0.to(torch.bfloat16), g1.to(torch.bfloat16)
    xa = fxa[:, None].to(g0.dtype).float()
    xb = fxb[:, None].to(g0.dtype).float()
    g0, g1 = g0.float(), g1.float()
    return ((g0[:, :c] * xa + g1[:, :c] * xb) * fya
            + (g0[:, c:] * xa + g1[:, c:] * xb) * fyb)


def _pair_level_taps(flat, col0, col1, wxa, wxb, wya, wyb, lw):
    """Pair-level taps: the (2 columns x C) windows at rows ``ry`` (flat
    column ``col0``) and ``min(ry+1, H-1)`` (``col1``) -> one fp32 ``[K, C]``
    sum per y tap. The x and y/level weights multiply in fp32 and round to
    the table dtype together; tap products are taken in fp32 and added in
    fp32 (``_yfold_forward`` :1223-1227). An e4m3 table's taps read as
    bf16 (:1221-1222), so its weights round to bf16."""
    wdt = torch.bfloat16 if flat.dtype == E4M3 else flat.dtype
    taps = []
    for col, wy in ((col0, wya), (col1, wyb)):
        wyl = wy * lw
        w0 = (wxa * wyl)[:, None].to(wdt).float()
        w1 = (wxb * wyl)[:, None].to(wdt).float()
        taps.append(_gather(flat, col).float() * w0
                    + _gather(flat, col + 1).float() * w1)
    return taps


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
    JAX ``_yfold_forward`` with its order of operations, or
    ``_gmajor_forward``'s when a level is group-split."""
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
    gmajor = any(packed.gsplit)
    out = torch.zeros((k, c), dtype=acc_dtype, device=dev)
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
        # pair level: wyb is 0 wherever row ry+1 is invalid, so the clamp
        # changes no weight
        col0 = packed.row_index(batch_row, view, ry, h) * (w + 1) + sx
        col1 = packed.row_index(batch_row, view,
                                torch.clamp(ry + 1, max=h - 1), h) \
            * (w + 1) + sx
        taps = _pair_level_taps(flat, col0, col1, wxa, wxb, wya, wyb, lw)
        if gmajor:        # both y taps in fp32, one add (_gmajor_forward)
            out = out + (taps[0] + taps[1]).to(acc_dtype)
        else:             # one add per y tap (_yfold_forward)
            for tap in taps:
                out = out + tap.to(acc_dtype)
    return out.reshape(q, s, p, c)


def msmv_halfrow_plain(packed: PackedFeatures,
                       sampling_locations: torch.Tensor,
                       scale_weights: torch.Tensor) -> torch.Tensor:
    """The all-fp32 half-row primal (query-major), JAX ``_msmv_halfrow``
    (:775; with group-split levels ``_halfrow_runmajor`` :701, which changes
    nothing but the order in which the same sums are written): every tap is
    a single table row read ``[row + sx + slot]`` cast to fp32, weighted by
    ``wx_slot * lw`` (x) and ``wy`` (the y half), all products and sums in
    fp32 (fp64 for fp64 locations, for ``gradcheck``), the result cast to
    ``table_acc_dtype`` once. Its autograd graph is what the sampling op's
    backward computes: a scatter-add of ``g * wy * wx * lw`` into the half
    rows, ``g`` dot each level's unweighted bilinear value for the scale
    weights, and the derivatives of the piecewise-linear slot weights for x
    and y."""
    _check_geometry(packed, sampling_locations, scale_weights)
    q, s, p, _ = sampling_locations.shape
    n, c = packed.num_views, packed.channels
    num_levels = len(packed.level_shapes)
    k = q * s * p
    dev = sampling_locations.device
    ct = (torch.float64 if sampling_locations.dtype == torch.float64
          else torch.float32)
    x = sampling_locations[..., 0].reshape(k)
    y = sampling_locations[..., 1].reshape(k)
    view = _view_index(sampling_locations[..., 2].reshape(k), n)
    slices = (torch.arange(s, device=dev) if packed.slice_map is None
              else packed.slice_map.to(device=dev, dtype=torch.int64))
    batch_row = slices.repeat_interleave(p).repeat(q)          # (q, s, p)
    lw_levels = scale_weights.reshape(k, num_levels).t().to(ct)
    out = torch.zeros((k, c), dtype=ct, device=dev)
    for lvl, (h, w) in enumerate(packed.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = _separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        lw = lw_levels[lvl]
        flat = packed.tables[lvl].reshape(-1, packed.row_width(lvl))
        if packed.yfold[lvl]:
            row = packed.row_index(batch_row, view, ry, h) * (w + 1)
            wy = torch.stack([wya, wyb], -1).to(ct)               # [K, 2]
            for slot, wx in ((0, wxa), (1, wxb)):
                g2 = flat[row + sx + slot].to(ct).reshape(k, 2, c)
                out = out + (g2 * wy[..., None]).sum(1) * (wx * lw)[:, None]
            continue
        for row_y, wy in ((ry, wya), (torch.clamp(ry + 1, max=h - 1), wyb)):
            row = packed.row_index(batch_row, view, row_y, h) * (w + 1)
            for slot, wx in ((0, wxa), (1, wxb)):
                g1 = flat[row + sx + slot].to(ct)
                out = out + g1 * (wx * wy * lw)[:, None]
    acc = table_acc_dtype(packed)
    if ct == torch.float64 and packed.tables[0].dtype == torch.float64:
        acc = torch.float64
    return out.reshape(q, s, p, c).to(acc)


def msmv_sampling_backward_plain(packed: PackedFeatures,
                                 sampling_locations: torch.Tensor,
                                 scale_weights: torch.Tensor,
                                 grad_out: torch.Tensor, table_grads=None):
    """Plain PyTorch version of the sampling backward: autograd of
    :func:`msmv_halfrow_plain` over the tables in their own dtype, which is
    JAX's transposed graph: each contribution is rounded to the table dtype
    (the adjoint of ``flat[idx].to(ct)``) and the index backward adds them in
    that dtype, one rounding per add, in index order. Returns
    ``(d_locations [Q, S, P, 3], d_scale_weights [Q, S, P, L])``.
    ``table_grads``: per level a buffer of the table's shape and dtype that
    the table's gradient is added to (one add in the table dtype), or None
    for no table gradient."""
    want_tables = table_grads is not None
    tables = [t.detach().requires_grad_(want_tables) for t in packed.tables]
    loc = sampling_locations.detach().requires_grad_()
    sw = scale_weights.detach().requires_grad_()
    with torch.enable_grad():
        out = msmv_halfrow_plain(packed.replace(tables=tables), loc, sw)
        leaves = [loc, sw] + (tables if want_tables else [])
        grads = torch.autograd.grad(out, leaves, grad_out.to(out.dtype))
    for buf, d in zip(table_grads or (), grads[2:], strict=True):
        buf.add_(d)
    return grads[0], grads[1]


def msmv_sampling_backward(packed: PackedFeatures,
                           sampling_locations: torch.Tensor,
                           scale_weights: torch.Tensor,
                           grad_out: torch.Tensor, table_grads=None):
    """The sampling op's backward on its own (what ``msmv_sampling``'s
    autograd Function runs): CPU tensors take the plain version, CUDA
    tensors launch ``csrc/msmv_sample_bwd.cu`` (or raise). Returns
    ``(d_locations, d_scale_weights)`` and adds the table gradients to
    ``table_grads`` (per level a buffer of the table's shape and dtype;
    None for no table gradient)."""
    if sampling_locations.device.type == "cpu":
        return msmv_sampling_backward_plain(
            packed, sampling_locations, scale_weights, grad_out, table_grads)
    return _msmv_sampling_backward_cuda(
        packed, sampling_locations, scale_weights, grad_out, table_grads)


msmv_sampling_backward.launches = 0  # in _msmv_sampling_backward_cuda


class _MsmvSampling(torch.autograd.Function):
    """Forward: the window forward (kernel or plain). Backward: the VJP of
    the half-row primal (kernel or plain), the JAX ``custom_vjp`` pairing.
    The level tables travel as tensor arguments so that autograd sees them.
    A table with a ``TableGrad`` (a pack's output) gets its gradient added
    to that buffer and none from autograd; any other table gets its
    gradient back in its own dtype. So does every table of a call whose
    forward ran inside a backward pass (the recompute of a reentrant
    ``torch.utils.checkpoint``): its backward runs in a nested pass, and
    the gradient it hands autograd reaches the pack through the outer one
    (``ops/msmv_pack.py``)."""

    @staticmethod
    def forward(ctx, packed, loc, sw, *tables):
        ctx.geometry = packed.replace(tables=(None,) * len(tables))
        ctx.recomputed = torch._C._current_graph_task_id() != -1
        ctx.save_for_backward(loc, sw, *tables)
        if loc.device.type == "cpu":
            return msmv_sampling_plain(packed, loc, sw)
        return _msmv_sampling_cuda(packed, loc, sw)

    @staticmethod
    def backward(ctx, grad_out):
        loc, sw, *tables = ctx.saved_tensors
        holders = ctx.geometry.table_grads
        shared = holders is not None and not ctx.recomputed
        bufs = None
        if any(ctx.needs_input_grad[3:]):
            bufs = ([h.accumulator(t) for h, t in zip(holders, tables)]
                    if shared else [torch.zeros_like(t) for t in tables])
        d_loc, d_sw = msmv_sampling_backward(
            ctx.geometry.replace(tables=tables), loc, sw,
            grad_out.contiguous(), bufs)
        d_tables = [None] * len(tables) if shared or bufs is None else bufs
        return (None, d_loc, d_sw, *d_tables)


def _hybrid_forward(packed: PackedFeatures, loc: torch.Tensor,
                    sw: torch.Tensor) -> torch.Tensor:
    """Slice-major hybrid path (JAX ``_yfold_forward`` with MXU tables,
    :1085-1126): the y-fold levels, a prefix of the level list, through the
    sampling op, then every one-hot level in one call that adds each level's
    result, cast to the accumulator dtype, in level order."""
    s, q, p, three = loc.shape
    levels = packed.level_shapes
    if three != 3 or s != packed.batch \
            or tuple(sw.shape) != (s, q, p, len(levels)):
        raise ValueError(f"hybrid sampling: locations {tuple(loc.shape)} and "
                         f"weights {tuple(sw.shape)} do not match "
                         f"{packed.batch} slices and {len(levels)} levels")
    if packed.num_groups != 1 or packed.slice_map is not None:
        raise ValueError("hybrid sampling takes pack_mlvl_feats' ungrouped "
                         "tables")
    n_yf = sum(1 for t in packed.tables if t is not None)
    if any(t is None for t in packed.tables[:n_yf]) or any(
            packed.mxu_tables[lvl] is None for lvl in range(n_yf, len(levels))):
        raise ValueError("hybrid sampling: the y-fold levels must come before "
                         "the one-hot levels")
    acc_dtype = table_acc_dtype(packed)
    c = packed.channels
    k = s * q * p
    if n_yf:
        prefix = PackedFeatures(packed.tables[:n_yf], s, packed.num_views,
                                levels[:n_yf], c)
        out = msmv_sampling(prefix, loc.transpose(0, 1).contiguous(),
                            sw[..., :n_yf].transpose(0, 1).contiguous())
        out = out.transpose(0, 1).reshape(k, c)   # a copy: updated in place
    else:
        out = torch.zeros((k, c), dtype=acc_dtype, device=loc.device)
    onehot = range(n_yf, len(levels))
    onehot_sample_levels([packed.mxu_tables[lvl] for lvl in onehot],
                         levels[n_yf:], list(onehot), loc, sw, out,
                         packed.num_views, c)
    return out.reshape(s, q, p, c)


def msmv_sampling(packed: PackedFeatures,
                  sampling_locations: torch.Tensor,
                  scale_weights: torch.Tensor,
                  qmajor: bool = True) -> torch.Tensor:
    """Production sampling op. Query-major by default (the JAX
    ``qmajor=True`` layout, which every caller in the port uses): locations
    ``[Q, S, P, 3]``, weights ``[Q, S, P, L]`` -> ``[Q, S, P, C]`` in
    ``table_acc_dtype``; with ``qmajor=False`` all three are slice-major
    ``[S, Q, P, ...]``. Tables with one-hot levels (``mxu_tables``, the
    hybrid impl) take the slice-major layout only, as in JAX. CPU tensors
    take the plain versions; CUDA tensors launch the kernels (or raise).
    Differentiable on the y-fold / pair path (see the module docstring); the
    hybrid one-hot path is forward only, as in JAX."""
    if any(t is not None for t in packed.mxu_tables):
        if qmajor:
            raise ValueError("the hybrid one-hot path takes slice-major "
                             "points only (qmajor=False)")
        return _hybrid_forward(packed, sampling_locations, scale_weights)
    if not qmajor:
        out = msmv_sampling(packed,
                            sampling_locations.transpose(0, 1).contiguous(),
                            scale_weights.transpose(0, 1).contiguous())
        return out.transpose(0, 1).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (sampling_locations, scale_weights,
                                      *packed.tables)):
        return _MsmvSampling.apply(packed, sampling_locations, scale_weights,
                                   *packed.tables)
    if sampling_locations.device.type == "cpu":
        return msmv_sampling_plain(packed, sampling_locations, scale_weights)
    return _msmv_sampling_cuda(packed, sampling_locations, scale_weights)


msmv_sampling.launches = 0  # kernel launches (counted in _msmv_sampling_cuda)
# the launches among them that read an e4m3 level
msmv_sampling.e4m3_launches = 0

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("msmv_sample")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmv_sample_forward.argtypes = [
            vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, ctypes.c_longlong,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.msmv_sample_forward.restype = ci
        _SIGNATURE_SET = True
    return lib


def sample_table_dtypes(dtypes):
    """The tables' dtype as the sampling kernel reads it, and which levels
    are e4m3: ``dtypes`` is one dtype or one a level. e4m3 levels read as
    bf16 levels holding the same values, so beside them every other level
    must be bf16 (an all-e4m3 ring reads as bf16). Raises ``ValueError``
    for a mix the kernel does not take."""
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes,)
    fp8 = tuple(d == E4M3 for d in dtypes)
    base = {d for d in dtypes if d != E4M3}
    if len(base) > 1:
        raise ValueError(f"msmv_sampling: tables of one dtype (or e4m3 "
                         f"beside bf16), not {sorted(map(str, base))}")
    base = base.pop() if base else torch.bfloat16
    if any(fp8) and base != torch.bfloat16:
        raise ValueError(f"msmv_sampling: e4m3 levels read as bf16, so the "
                         f"other levels must be bf16, not {base}")
    return base, fp8


def sample_lanes_per_point(channels: int, dtype) -> int:
    """How many lanes of a warp share one sampling point in the kernel
    (:func:`~.msmv_onehot.lanes_per_point`: 16 bytes a lane; C=64 takes 8
    lanes in bf16 and 16 in fp32). ``dtype``: the tables' dtype or one a
    level; an e4m3 level keeps a bf16 lane's channels (8 a lane, 8 bytes
    read where a bf16 lane reads 16, see :func:`sample_table_dtypes`).
    Raises ``ValueError`` for what the kernel does not take."""
    return lanes_per_point(channels, sample_table_dtypes(dtype)[0],
                           "msmv_sampling")


def _check_cuda_operands(packed, loc, sw):
    """What both sampling kernels ask of their operands; returns the table
    dtype as the kernels read it (:func:`sample_table_dtypes`), the e4m3
    flag of each level, the lanes a point takes and the int32 slice map."""
    _check_geometry(packed, loc, sw)
    dev = loc.device
    if not loc.is_cuda:
        raise ValueError(f"msmv_sampling: no kernel for device {dev}")
    for name, t in (("locations", loc), ("scale weights", sw)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"msmv_sampling: {name} must be contiguous fp32 "
                             f"on {dev}")
    dtype, fp8 = sample_table_dtypes([t.dtype for t in packed.tables])
    lanes = sample_lanes_per_point(packed.channels, dtype)
    if not 1 <= len(packed.level_shapes) <= _MAX_LEVELS:
        raise ValueError(f"msmv_sampling: the kernel takes 1 to {_MAX_LEVELS} "
                         f"levels, not {len(packed.level_shapes)}")
    for lvl, (t, (h, w)) in enumerate(zip(packed.tables,
                                          packed.level_shapes)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("msmv_sampling: tables must be contiguous, on "
                             f"{dev}")
        if t.dim() != 3 or t.shape[1:] != (w + 1, packed.row_width(lvl)) \
                or t.shape[0] % h:
            raise ValueError(f"msmv_sampling: level {lvl} table "
                             f"{tuple(t.shape)} does not match its shape "
                             f"{h}x{w} and mode")
        if t.data_ptr() % _LANE_BYTES or t.shape[0] * (w + 1) >= 2 ** 31:
            raise ValueError(f"msmv_sampling: level {lvl} table must be "
                             f"{_LANE_BYTES}-byte aligned with fewer than "
                             "2^31 columns in all")
    q, s, p, _ = loc.shape
    if q * s * p * lanes >= 2 ** 31:
        raise ValueError(f"msmv_sampling: {q * s * p} points are more than "
                         "one launch takes")
    slice_map = (torch.arange(s, device=dev) if packed.slice_map is None
                 else packed.slice_map)
    slice_map = slice_map.to(device=dev, dtype=torch.int32).contiguous()
    return dtype, fp8, lanes, slice_map


def _level_arrays(packed, tables):
    """ctypes arrays of the per-level table pointers, heights, widths and
    modes that the C entries take."""
    num_levels = len(packed.level_shapes)
    return ((ctypes.c_void_p * num_levels)(*[t.data_ptr() for t in tables]),
            (ctypes.c_int * num_levels)(*[h for h, _ in packed.level_shapes]),
            (ctypes.c_int * num_levels)(*[w for _, w in packed.level_shapes]),
            (ctypes.c_int * num_levels)(*[int(v) for v in packed.yfold]))


def _msmv_sampling_cuda(packed, loc, sw):
    dtype, fp8, lanes, slice_map = _check_cuda_operands(packed, loc, sw)
    dev = loc.device
    q, s, p, _ = loc.shape
    c = packed.channels
    out_dtype = table_acc_dtype(packed)
    out = torch.empty((q, s, p, c), dtype=out_dtype, device=dev)
    num_levels = len(packed.level_shapes)
    tables, heights, widths, yfold = _level_arrays(packed, packed.tables)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_sample_forward(
            tables, heights, widths, yfold,
            (ctypes.c_int * num_levels)(*map(int, fp8)), num_levels,
            loc.data_ptr(), sw.data_ptr(), slice_map.data_ptr(),
            out.data_ptr(), q * s * p, s, p, packed.num_views,
            packed.num_groups, c, int(dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(any(packed.gsplit)), lanes,
            stream)
    build.check(lib, "msmv_sample", rc)
    msmv_sampling.launches += 1
    msmv_sampling.e4m3_launches += any(fp8)
    return out


def _msmv_sampling_backward_cuda(packed, loc, sw, grad_out, grads=None):
    """One launch of ``msmv_sample_backward`` on the current stream: ``d loc``
    and ``d sw`` written once per point, the table gradient added with
    vector reductions in the table dtype to ``grads`` (per level a buffer of
    the table's shape and dtype; None for no table gradient). Returns
    ``(d_loc, d_sw)``."""
    dtype, fp8, lanes, slice_map = _check_cuda_operands(packed, loc, sw)
    if any(fp8):
        raise ValueError("msmv_sampling backward: e4m3 tables are a "
                         "streaming ring's; training samples exact tables")
    dev = loc.device
    q, s, p, _ = loc.shape
    c = packed.channels
    if tuple(grad_out.shape) != (q, s, p, c) or grad_out.dtype != dtype \
            or grad_out.device != dev or not grad_out.is_contiguous() \
            or grad_out.data_ptr() % _LANE_BYTES:
        raise ValueError(
            f"msmv_sampling backward: the output gradient must be a "
            f"contiguous, {_LANE_BYTES}-byte aligned {dtype} "
            f"{(q, s, p, c)} tensor on {dev}, got {grad_out.dtype} "
            f"{tuple(grad_out.shape)}")
    num_levels = len(packed.level_shapes)
    if grads is not None:
        for t, buf in zip(packed.tables, grads, strict=True):
            if buf.shape != t.shape or buf.dtype != dtype \
                    or buf.device != dev or not buf.is_contiguous() \
                    or buf.data_ptr() % _LANE_BYTES:
                raise ValueError("msmv_sampling backward: each table "
                                 "gradient must be contiguous, "
                                 f"{_LANE_BYTES}-byte aligned, of its "
                                 "table's shape and dtype")
    d_loc = torch.empty_like(loc)
    d_sw = torch.empty_like(sw)
    tables, heights, widths, yfold = _level_arrays(packed, packed.tables)
    grad_ptrs = (ctypes.c_void_p * num_levels)(
        *([None] * num_levels if grads is None
          else [t.data_ptr() for t in grads]))
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_sample_backward(
            tables, grad_ptrs, heights, widths, yfold, num_levels,
            loc.data_ptr(), sw.data_ptr(), slice_map.data_ptr(),
            grad_out.data_ptr(), d_loc.data_ptr(), d_sw.data_ptr(),
            q * s * p, s, p, packed.num_views, packed.num_groups, c,
            int(dtype == torch.bfloat16), int(grads is not None), lanes,
            stream)
    build.check(lib, "msmv_sample_bwd", rc)
    msmv_sampling_backward.launches += 1
    return d_loc, d_sw


_BWD_SIGNATURE_SET = False


def _bwd_lib():
    global _BWD_SIGNATURE_SET
    lib = build.load("msmv_sample_bwd")
    if not _BWD_SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmv_sample_backward.argtypes = [
            vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp,
            ctypes.c_longlong, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.msmv_sample_backward.restype = ci
        _BWD_SIGNATURE_SET = True
    return lib
