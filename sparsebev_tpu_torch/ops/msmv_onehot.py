"""Bilinear sampling of one small pyramid level, for the hybrid sampling path.

Counterpart of ``sparsebev_tpu/ops/msmv_pallas.py::onehot_sample_level``
(pallas_call :132, body ``_onehot_sample_kernel`` :54). The TPU kernel runs
the sample as dense one-hot matmuls because the TPU gathers slowly; the CUDA
kernel ``csrc/msmv_onehot.cu`` reads the four taps of each point directly.
:func:`onehot_sample_level_plain` is its plain PyTorch version.

Contract (as in JAX, :97-108): ``feat_table [S, N*H, W*C]`` bf16 (one slice's
level features per row block); ``rows0``/``rows1`` int32 ``[S, K]`` the table
rows (view * H + y) of the two y taps, in range, a tap out of the image
carrying a zero weight; ``wy0``/``wy1`` fp32 ``[S, K]`` the y weights with
the level weight folded in; ``x0`` int32 ``[S, K]`` the left column in
``[0, W-2]``; ``wx0``/``wx1`` fp32 ``[S, K]`` the weights of columns ``x0``
and ``x0+1``. Returns fp32 ``[S, K, C]``. The JAX ``query_block`` and
``interpret`` arguments are TPU tiling and have no counterpart.

bf16 bits: the JAX code rounds in four places, and XLA on the CPU keeps all
four, under ``jax.jit`` as well as op by op (unlike the y-fold fold, whose
tap products jitted XLA keeps in fp32): the row weights are rounded to bf16
(``wy0 + wy1`` summed first where both taps fall on one row, :119), the x
weights are rounded to bf16, each row pair sums in fp32 (``g = a @ F``, exact
products), and each column's ``g * wx`` is rounded to bf16 before the two
columns add in fp32 (:81-82). The plain version and the kernel both compute
exactly that and give the bits of jitted JAX.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

_INT_ARGS = ("rows0", "rows1", "x0")  # int32; the other point arrays fp32


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
    """One level of the hybrid path (contract in the module docstring). A
    CPU table takes the plain version; a CUDA table launches the kernel (or
    raises)."""
    if feat_table.device.type == "cpu":
        return onehot_sample_level_plain(feat_table, rows0, rows1, wy0, wy1,
                                         x0, wx0, wx1, w, c)
    return _onehot_cuda(feat_table, rows0, rows1, wy0, wy1, x0, wx0, wx1, w,
                        c)


onehot_sample_level.launches = 0  # kernel launches (counted in _onehot_cuda)

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("msmv_onehot")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmv_onehot_sample_level.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ctypes.c_longlong, ci,
            ci, ci, vp]
        lib.msmv_onehot_sample_level.restype = ci
        _SIGNATURE_SET = True
    return lib


def _onehot_cuda(feat_table, rows0, rows1, wy0, wy1, x0, wx0, wx1, w, c):
    dev = feat_table.device
    if not feat_table.is_cuda:
        raise ValueError(f"onehot_sample_level: no kernel for device {dev}")
    args = dict(rows0=rows0, rows1=rows1, wy0=wy0, wy1=wy1, x0=x0, wx0=wx0,
                wx1=wx1)
    _check(feat_table, w, c, args)
    for name, t in [("table", feat_table), *args.items()]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"onehot_sample_level: {name} must be contiguous "
                             f"on {dev}")
    s, nh, _ = feat_table.shape
    k = rows0.shape[1]
    out = torch.empty((s, k, c), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.msmv_onehot_sample_level(
            feat_table.data_ptr(), rows0.data_ptr(), rows1.data_ptr(),
            wy0.data_ptr(), wy1.data_ptr(), x0.data_ptr(), wx0.data_ptr(),
            wx1.data_ptr(), out.data_ptr(), s, k, nh, w, c, stream)
    build.check(lib, "msmv_onehot", rc)
    onehot_sample_level.launches += 1
    return out
