"""Bilinear sampling of the small pyramid levels, for the hybrid sampling path.

Counterpart of ``sparsebev_tpu/ops/msmv_pallas.py::onehot_sample_level``
(pallas_call :132, body ``_onehot_sample_kernel`` :54) and of the branch of
``sparsebev_tpu/ops/msmv_sampling.py::_yfold_forward`` that calls it
(:1088-1125). The TPU kernel runs the sample as dense one-hot matmuls because
the TPU gathers slowly; the CUDA kernels of ``csrc/msmv_onehot.cu`` read the
four taps of each point directly. Two entries:

:func:`onehot_sample_level` is the JAX function's counterpart, one level from
precomputed per-point arguments. Contract (as in JAX, :97-108): ``feat_table
[S, N*H, W*C]`` bf16 (one slice's level features per row block);
``rows0``/``rows1`` int32 ``[S, K]`` the table rows (view * H + y) of the two
y taps, in range, a tap out of the image carrying a zero weight;
``wy0``/``wy1`` fp32 ``[S, K]`` the y weights with the level weight folded
in; ``x0`` int32 ``[S, K]`` the left column in ``[0, W-2]``; ``wx0``/``wx1``
fp32 ``[S, K]`` the weights of columns ``x0`` and ``x0+1``. Returns fp32
``[S, K, C]``. The JAX ``query_block`` and ``interpret`` arguments are TPU
tiling and have no counterpart.

:func:`onehot_sample_levels` is the whole one-hot part of a hybrid sampling
call in one launch: from the slice-major points and scale weights it derives
each level's per-point arguments (:func:`_onehot_level_weights`, the JAX
branch :1096-1115), samples every level and adds each level's result, cast to
the accumulator's dtype, to the accumulator in level order (:1125).

bf16 bits: the JAX code rounds in four places, and XLA on the CPU keeps all
four, under ``jax.jit`` as well as op by op (unlike the y-fold fold, whose
tap products jitted XLA keeps in fp32): the row weights are rounded to bf16
(``wy0 + wy1`` summed first where both taps fall on one row, :119), the x
weights are rounded to bf16, each row pair sums in fp32 (``g = a @ F``, exact
products), and each column's ``g * wx`` is rounded to bf16 before the two
columns add in fp32 (:81-82). The plain versions and the kernels compute
exactly that and give the bits of jitted JAX.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..kernels import build

_INT_ARGS = ("rows0", "rows1", "x0")  # int32; the other point arrays fp32
LANE_BYTES = 16      # each lane of a sampling kernel loads 16 bytes of a run
MAX_LEVELS = 8       # the kernels are instantiated for 1..8 levels
_MAX_SLICES = 65535  # the one-hot kernels take a slice a blockIdx.y


def lanes_per_point(channels: int, dtype: torch.dtype, op: str) -> int:
    """How many lanes of a warp share one point in the sampling kernels:
    each lane owns one 16-byte run of the ``channels`` table values, and a
    point takes a power-of-two group of lanes (C=64: 8 lanes in bf16, 16 in
    fp32, so a warp carries 4 or 2 points). Raises ``ValueError`` (in the
    name of ``op``) for what the kernels do not take: another dtype, a
    channel run that is no multiple of 16 bytes, or one longer than a warp's
    512 bytes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{op}: no kernel for {dtype} tables")
    nbytes = channels * dtype.itemsize
    if channels < 1 or nbytes % LANE_BYTES:
        raise ValueError(
            f"{op}: the kernel reads {LANE_BYTES}-byte runs, so "
            f"channels * itemsize must be a multiple of {LANE_BYTES} (got "
            f"{channels} channels of {dtype}: {nbytes} bytes)")
    runs = nbytes // LANE_BYTES
    if runs > 32:
        raise ValueError(
            f"{op}: a point's {channels} channels of {dtype} take "
            f"{runs} 16-byte runs, more than the 32 lanes of a warp")
    return 1 << (runs - 1).bit_length()


def onehot_lanes_per_point(channels: int, table_dtype: torch.dtype) -> int:
    """:func:`lanes_per_point` for the one-hot kernels, whose tables are
    bf16 only (C=64: 8 lanes, the P=4 points of a (slice, query) a warp)."""
    if table_dtype != torch.bfloat16:
        raise ValueError("onehot_sample_level: the table must be bf16 (the "
                         f"hybrid pack's MXU tables), got {table_dtype}")
    return lanes_per_point(channels, table_dtype, "onehot_sample_level")


def _clamp_pixels(pix, size):
    # pixels beyond [-2, size+1] have every tap masked; clamping them keeps
    # the integer conversion in range and changes no weight
    return pix.clamp(-2.0, float(size + 1))


def _view_index(v, n):
    return torch.round(v * (n - 1)).clamp(0, n - 1).to(torch.int64)


def _onehot_level_weights(x, y, view, lw, h, w):
    """Per-point arguments of :func:`onehot_sample_level` for one level (the
    JAX hybrid branch, :1096-1115): the rows of the two y taps, their
    weights with ``lw`` folded in, the left column of a window clipped to
    ``[0, W-2]`` and its two columns' weights, remapped at both image
    edges."""
    x_pix = _clamp_pixels(x * (w - 1), w)
    y_pix = _clamp_pixels(y * (h - 1), h)
    x0f = torch.floor(x_pix)
    y0f = torch.floor(y_pix)
    lx = x_pix - x0f
    ly = y_pix - y0f
    ix0 = x0f.to(torch.int64)
    iy0 = y0f.to(torch.int64)
    inx0 = (ix0 >= 0) & (ix0 <= w - 1)
    inx1 = (ix0 + 1 >= 0) & (ix0 + 1 <= w - 1)
    iny0 = (iy0 >= 0) & (iy0 <= h - 1)
    iny1 = (iy0 + 1 >= 0) & (iy0 + 1 <= h - 1)
    wy0 = (1.0 - ly) * iny0 * lw
    wy1 = ly * iny1 * lw
    zero = torch.zeros_like(lx)
    s0 = ix0.clamp(0, w - 2)
    wx0 = (torch.where(s0 == ix0, (1.0 - lx) * inx0, zero)
           + torch.where(s0 == ix0 + 1, lx * inx1, zero))
    wx1 = (torch.where(s0 + 1 == ix0, (1.0 - lx) * inx0, zero)
           + torch.where(s0 + 1 == ix0 + 1, lx * inx1, zero))
    rows0 = view * h + iy0.clamp(0, h - 1)
    rows1 = view * h + (iy0 + 1).clamp(0, h - 1)
    i32 = torch.int32
    return (rows0.to(i32), rows1.to(i32), wy0, wy1, s0.to(i32), wx0, wx1)


def _check(feat_table, w, c, scalars):
    if feat_table.dim() != 3 or feat_table.shape[2] != w * c:
        raise ValueError(f"onehot_sample_level: table {tuple(feat_table.shape)}"
                         f" is not [S, N*H, W*C] with W={w}, C={c}")
    if feat_table.dtype != torch.bfloat16:
        raise ValueError("onehot_sample_level: the table must be bf16 (the "
                         f"hybrid pack's MXU tables), got {feat_table.dtype}")
    if w < 2:
        raise ValueError("onehot_sample_level: a level needs W >= 2")
    s = feat_table.shape[0]
    shape = scalars["rows0"].shape
    if len(shape) != 2 or shape[0] != s:
        raise ValueError(f"onehot_sample_level: point arrays {tuple(shape)} "
                         f"are not [S={s}, K]")
    for name, t in scalars.items():
        want = torch.int32 if name in _INT_ARGS else torch.float32
        if t.shape != shape or t.dtype != want:
            raise ValueError(f"onehot_sample_level: {name} must be "
                             f"{want} {tuple(shape)}")


def onehot_sample_level_plain(feat_table, rows0, rows1, wy0, wy1, x0, wx0,
                              wx1, w: int, c: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX function's roundings (module
    docstring), taps read by index."""
    args = dict(rows0=rows0, rows1=rows1, wy0=wy0, wy1=wy1, x0=x0, wx0=wx0,
                wx1=wx1)
    _check(feat_table, w, c, args)
    s, nh, _ = feat_table.shape
    k = rows0.shape[1]
    bf = torch.bfloat16
    same = rows0 == rows1
    a0 = torch.where(same, wy0 + wy1, wy0).to(bf).float()[..., None]
    a1 = torch.where(same, torch.zeros_like(wy1),
                     wy1.to(bf).float())[..., None]
    flat = feat_table.reshape(s * nh * w, c)
    base = torch.arange(s, device=feat_table.device)[:, None] * nh
    col0 = ((base + rows0.long()) * w + x0.long()).reshape(-1)
    col1 = ((base + rows1.long()) * w + x0.long()).reshape(-1)

    def column(dx, wx):
        f0 = flat[col0 + dx].float().reshape(s, k, c)
        f1 = flat[col1 + dx].float().reshape(s, k, c)
        g = a0 * f0 + a1 * f1
        return (g * wx.to(bf).float()[..., None]).to(bf).float()

    return column(0, wx0) + column(1, wx1)


def onehot_sample_level(feat_table, rows0, rows1, wy0, wy1, x0, wx0, wx1,
                        w: int, c: int) -> torch.Tensor:
    """One level from precomputed point arguments (contract in the module
    docstring). A CPU table takes the plain version; a CUDA table launches
    the kernel (or raises)."""
    if feat_table.device.type == "cpu":
        return onehot_sample_level_plain(feat_table, rows0, rows1, wy0, wy1,
                                         x0, wx0, wx1, w, c)
    return _onehot_cuda(feat_table, rows0, rows1, wy0, wy1, x0, wx0, wx1, w,
                        c)


onehot_sample_level.launches = 0  # kernel launches (counted in _onehot_cuda)


def _check_levels(tables, level_shapes, level_index, loc, sw, out, num_views,
                  c):
    op = "onehot_sample_levels"
    if not (len(tables) == len(level_shapes) == len(level_index)):
        raise ValueError(f"{op}: {len(tables)} tables, {len(level_shapes)} "
                         f"shapes and {len(level_index)} weight indices")
    if not 1 <= len(tables) <= MAX_LEVELS:
        raise ValueError(f"{op}: the kernel takes 1 to {MAX_LEVELS} levels, "
                         f"not {len(tables)}")
    if loc.dim() != 4 or loc.shape[3] != 3:
        raise ValueError(f"{op}: locations {tuple(loc.shape)} are not "
                         "[S, Q, P, 3]")
    s, q, p, _ = loc.shape
    if sw.dim() != 4 or sw.shape[:3] != loc.shape[:3]:
        raise ValueError(f"{op}: scale weights {tuple(sw.shape)} do not match "
                         f"locations {tuple(loc.shape)}")
    if sw.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{op}: scale weights must be bf16 or fp32, got "
                         f"{sw.dtype}")
    if tuple(out.shape) != (s * q * p, c) \
            or out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{op}: the accumulator {tuple(out.shape)} "
                         f"{out.dtype} is not bf16 or fp32 "
                         f"[{s * q * p}, {c}]")
    for table, (h, w), idx in zip(tables, level_shapes, level_index):
        if table.dtype != torch.bfloat16:
            raise ValueError(f"{op}: the tables must be bf16 (the hybrid "
                             f"pack's MXU tables), got {table.dtype}")
        if tuple(table.shape) != (s, num_views * h, w * c) or w < 2:
            raise ValueError(f"{op}: table {tuple(table.shape)} is not "
                             f"[S={s}, N*H, W*C] with N={num_views}, H={h}, "
                             f"W={w} >= 2, C={c}")
        if not 0 <= idx < sw.shape[3]:
            raise ValueError(f"{op}: weight index {idx} is outside the "
                             f"{sw.shape[3]} levels of the scale weights")


def onehot_sample_levels_plain(tables: Sequence[torch.Tensor], level_shapes,
                               level_index, loc, sw, out, num_views: int,
                               c: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`onehot_sample_levels`: per level the
    point arguments, :func:`onehot_sample_level_plain`, the cast to the
    accumulator's dtype and the add."""
    _check_levels(tables, level_shapes, level_index, loc, sw, out, num_views,
                  c)
    s, q, p, _ = loc.shape
    k = s * q * p
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = _view_index(loc[..., 2].reshape(k), num_views)
    acc = out
    for table, (h, w), idx in zip(tables, level_shapes, level_index):
        args = _onehot_level_weights(x, y, view,
                                     sw[..., idx].reshape(k).float(), h, w)
        res = onehot_sample_level_plain(
            table, *[a.reshape(s, q * p) for a in args], w=w, c=c)
        acc = acc + res.reshape(k, c).to(out.dtype)
    return out.copy_(acc)


def onehot_sample_levels(tables: Sequence[torch.Tensor], level_shapes,
                         level_index, loc, sw, out, num_views: int,
                         c: int) -> torch.Tensor:
    """Every one-hot level of a hybrid sampling call, added to ``out`` IN
    PLACE. ``tables``: bf16 ``[S, N*H_l, W_l*C]`` per level with
    ``level_shapes`` ``(H_l, W_l)``; ``loc [S, Q, P, 3]`` (x, y in [0, 1],
    view / (N-1)); ``sw [S, Q, P, L]`` bf16 or fp32, of which level ``l``
    reads entry ``level_index[l]``; ``out [S*Q*P, C]`` bf16 or fp32, the
    accumulator: per level, in the order given, ``out = out + res.to(out
    dtype)`` with ``res`` the fp32 result of :func:`onehot_sample_level` on
    that level's point arguments. Returns ``out``. CPU tensors take the
    plain version; CUDA tensors launch one kernel (or raise)."""
    if loc.device.type == "cpu":
        return onehot_sample_levels_plain(tables, level_shapes, level_index,
                                          loc, sw, out, num_views, c)
    return _onehot_levels_cuda(tables, level_shapes, level_index, loc, sw,
                               out, num_views, c)


# kernel launches (counted in _onehot_levels_cuda)
onehot_sample_levels.launches = 0

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("msmv_onehot")
    if not _SIGNATURE_SET:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.msmv_onehot_sample_level.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ll, ci, ci, ci, ci, vp]
        lib.msmv_onehot_sample_level.restype = ci
        lib.msmv_onehot_sample_levels.argtypes = [
            vp, vp, vp, vp, ci, vp, vp, ci, ci, vp, ci, ci, ll, ci, ci, ci,
            vp]
        lib.msmv_onehot_sample_levels.restype = ci
        _SIGNATURE_SET = True
    return lib


def _onehot_cuda(feat_table, rows0, rows1, wy0, wy1, x0, wx0, wx1, w, c):
    dev = feat_table.device
    if not feat_table.is_cuda:
        raise ValueError(f"onehot_sample_level: no kernel for device {dev}")
    args = dict(rows0=rows0, rows1=rows1, wy0=wy0, wy1=wy1, x0=x0, wx0=wx0,
                wx1=wx1)
    _check(feat_table, w, c, args)
    lanes = onehot_lanes_per_point(c, feat_table.dtype)
    for name, t in [("table", feat_table), *args.items()]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"onehot_sample_level: {name} must be contiguous "
                             f"on {dev}")
    s, nh, _ = feat_table.shape
    k = rows0.shape[1]
    if feat_table.data_ptr() % LANE_BYTES or s * nh * w >= 2 ** 31 \
            or s * k * lanes >= 2 ** 31 or s > _MAX_SLICES:
        raise ValueError("onehot_sample_level: the table must be "
                         f"{LANE_BYTES}-byte aligned with fewer than 2^31 "
                         f"columns in all, and {s} slices of {k} points "
                         "must fit one launch")
    out = torch.empty((s, k, c), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_onehot_sample_level(
            feat_table.data_ptr(), rows0.data_ptr(), rows1.data_ptr(),
            wy0.data_ptr(), wy1.data_ptr(), x0.data_ptr(), wx0.data_ptr(),
            wx1.data_ptr(), out.data_ptr(), s, k, nh, w, c, lanes, stream)
    build.check(lib, "msmv_onehot", rc)
    onehot_sample_level.launches += 1
    return out


def _onehot_levels_cuda(tables, level_shapes, level_index, loc, sw, out,
                        num_views, c):
    op = "onehot_sample_levels"
    dev = loc.device
    if not loc.is_cuda:
        raise ValueError(f"{op}: no kernel for device {dev}")
    _check_levels(tables, level_shapes, level_index, loc, sw, out, num_views,
                  c)
    lanes = onehot_lanes_per_point(c, tables[0].dtype)
    if loc.dtype != torch.float32:
        raise ValueError(f"{op}: locations must be fp32, got {loc.dtype}")
    for name, t in [("locations", loc), ("scale weights", sw),
                    ("accumulator", out),
                    *[(f"table {i}", t) for i, t in enumerate(tables)]]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous on {dev}")
    s, q, p, _ = loc.shape
    k = s * q * p
    for t in (out, *tables):
        if t.data_ptr() % LANE_BYTES:
            raise ValueError(f"{op}: tables and accumulator must be "
                             f"{LANE_BYTES}-byte aligned")
    if k * lanes >= 2 ** 31 or s > _MAX_SLICES or any(
            s * num_views * h * w >= 2 ** 31 for h, w in level_shapes):
        raise ValueError(f"{op}: {s} slices of {q * p} points or a table's "
                         "columns are more than one launch takes")
    n = len(tables)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_onehot_sample_levels(
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in tables]),
            (ctypes.c_int * n)(*[h for h, _ in level_shapes]),
            (ctypes.c_int * n)(*[w for _, w in level_shapes]),
            (ctypes.c_int * n)(*level_index), n, loc.data_ptr(),
            sw.data_ptr(), int(sw.dtype == torch.bfloat16), sw.shape[3],
            out.data_ptr(), int(out.dtype == torch.bfloat16), s, q * p,
            num_views, c, lanes, stream)
    build.check(lib, "msmv_onehot", rc)
    onehot_sample_levels.launches += 1
    return out
