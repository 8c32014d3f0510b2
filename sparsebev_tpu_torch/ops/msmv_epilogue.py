"""Tap-weight epilogue of the y-fold sampling forward over gathered windows.

Counterpart of ``sparsebev_tpu/ops/msmv_epilogue_pallas.py::
tap_fold_epilogue`` (pallas_call :100, body ``_tap_fold_kernel`` :51): the CUDA
kernel ``csrc/tap_fold.cu``, and :func:`tap_fold_epilogue_plain` beside it.
As in the JAX package it is reached through this entry point only; the
sampling op (``msmv_sampling.py``) folds its windows inside its own kernel.

Per level: windows ``[K, 2, 2C]`` (bf16 or fp32; the two columns of a
y-fold row, ``feat[y] || feat[y+1]``) and weights ``[K, 4]`` fp32
``(wxa, wxb, wya * lw, wyb * lw)``. In fp32, level by level,
``acc += (g0 * wxa + g1 * wxb) * wy`` over the 2C lanes, with ``wy`` the
third weight on the first C lanes and the fourth on the second; then
``out = acc[:, :C] + acc[:, C:]`` in ``out_dtype``. The TPU kernel's
``[2C, C]`` stacked-identity matmul is that add. The kernel keeps this
order and, built with ``--fmad=false``, gives the plain version's bits.
(Jitted XLA on the CPU contracts these multiply-adds into FMAs, so the JAX
function's fp32 bits differ from this order by a few ulps; see
``tests/test_torch_epilogue.py``.) The JAX ``k_blk`` and ``interpret``
arguments are TPU tiling and have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..kernels import build
from .autograd_guard import refuse_backward


def _check(gathered, weights, c):
    if not gathered or len(gathered) != len(weights):
        raise ValueError("tap_fold_epilogue: one weight array per level")
    k = gathered[0].shape[0]
    for g, w in zip(gathered, weights):
        if tuple(g.shape) != (k, 2, 2 * c):
            raise ValueError(f"tap_fold_epilogue: windows {tuple(g.shape)} "
                             f"are not [K={k}, 2, 2C={2 * c}]")
        if tuple(w.shape) != (k, 4) or w.dtype != torch.float32:
            raise ValueError(f"tap_fold_epilogue: weights must be fp32 "
                             f"[{k}, 4], got {w.dtype} {tuple(w.shape)}")
    return k


def tap_fold_epilogue_plain(gathered: Sequence[torch.Tensor],
                            weights: Sequence[torch.Tensor], c: int,
                            out_dtype) -> torch.Tensor:
    """Plain PyTorch version (the order of the module docstring)."""
    k = _check(gathered, weights, c)
    acc = torch.zeros((k, 2 * c), dtype=torch.float32,
                      device=gathered[0].device)
    for g, w in zip(gathered, weights):
        wy = torch.cat([w[:, 2:3].expand(k, c), w[:, 3:4].expand(k, c)], 1)
        acc = acc + (g[:, 0].float() * w[:, 0:1]
                     + g[:, 1].float() * w[:, 1:2]) * wy
    return (acc[:, :c] + acc[:, c:]).to(out_dtype)


def tap_fold_epilogue(gathered: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor], c: int,
                      out_dtype) -> torch.Tensor:
    """``[K, C]`` in ``out_dtype`` from per-level windows and weights. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if gathered[0].device.type == "cpu":
        return tap_fold_epilogue_plain(gathered, weights, c, out_dtype)
    return _tap_fold_cuda(gathered, weights, c, out_dtype)


tap_fold_epilogue.launches = 0  # kernel launches (counted in _tap_fold_cuda)

_SIGNATURE_SET = False
_MAX_LEVELS = 8


def _lib():
    global _SIGNATURE_SET
    lib = build.load("tap_fold")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tap_fold_epilogue.argtypes = [vp, vp, ci, vp, ctypes.c_longlong,
                                          ci, ci, ci, vp]
        lib.tap_fold_epilogue.restype = ci
        _SIGNATURE_SET = True
    return lib


def _tap_fold_cuda(gathered, weights, c, out_dtype):
    dev = gathered[0].device
    if not gathered[0].is_cuda:
        raise ValueError(f"tap_fold_epilogue: no kernel for device {dev}")
    refuse_backward("tap_fold_epilogue", [list(gathered), list(weights)])
    k = _check(gathered, weights, c)
    num_levels = len(gathered)
    if num_levels > _MAX_LEVELS:
        raise ValueError(f"tap_fold_epilogue: at most {_MAX_LEVELS} levels")
    in_dtype = gathered[0].dtype
    for dt in (in_dtype, out_dtype):
        if dt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"tap_fold_epilogue: no kernel for {dt}")
    for t in (*gathered, *weights):
        if t.device != dev or not t.is_contiguous() or \
                t.dtype not in (in_dtype, torch.float32) or \
                t.data_ptr() % 16:
            raise ValueError("tap_fold_epilogue: windows (one dtype) and "
                             f"weights must be contiguous, 16-byte aligned, "
                             f"on {dev}")
    if any(g.dtype != in_dtype for g in gathered):
        raise ValueError("tap_fold_epilogue: windows of one dtype")
    out = torch.empty((k, c), dtype=out_dtype, device=dev)
    ptrs = (ctypes.c_void_p * num_levels)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tap_fold_epilogue(
            ptrs(*[g.data_ptr() for g in gathered]),
            ptrs(*[w.data_ptr() for w in weights]), num_levels,
            out.data_ptr(), k, c, int(in_dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    build.check(lib, "tap_fold", rc)
    tap_fold_epilogue.launches += 1
    return out
