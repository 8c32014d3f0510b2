"""The y-fold pack: one pyramid level -> grouped y-fold sampling tables.

Counterpart of ``sparsebev_tpu/ops/msmv_pack_pallas.py::pack_level``. The
CUDA kernel (``csrc/msmv_pack.cu``) replaces the Pallas kernel
``pack_level_tpu`` (:63, body ``_pack_kernel`` :32); :func:`pack_level_plain`
is the plain PyTorch version of ``_pack_level_xla`` (:101).

Layout: ``feat [M, H, W, C] -> [M, H, G, W+1, 2Cg]``. Row h of group g holds
``feat[h, :, g] ‖ feat[h+1, :, g]`` on the channel axis (row H-1's second
half is zeros) plus a zero guard column at x = W, so one (2 columns x 2Cg)
window carries all four bilinear taps of a point.

Bound (flagship r50, one new frame, 4 levels, bf16): 45.9 MB read + 92.7 MB
written, about 41 us at 3.35 TB/s. The kernel reads each input element once
and writes each output element once with 16-byte vector accesses.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build


def pack_level_plain(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain PyTorch y-fold pack (the formulation of ``_pack_level_xla``)."""
    m, h, w, c = feat.shape
    g = num_groups
    cg = c // g
    f = feat.reshape(m, h, w, g, cg)
    fy = torch.cat([f[:, 1:], torch.zeros_like(f[:, :1])], dim=1)
    t2 = torch.stack([f, fy], dim=-2)                  # [M,H,W,G,2,Cg]
    t2 = t2.permute(0, 1, 3, 2, 4, 5)                  # [M,H,G,W,2,Cg]
    t2 = F.pad(t2, (0, 0, 0, 0, 0, 1))                 # zero guard column
    return t2.reshape(m, h, g, w + 1, 2 * cg)


def pack_level(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``[M, H, W, C] -> [M, H, G, W+1, 2Cg]``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if feat.device.type == "cpu":
        return pack_level_plain(feat, num_groups)
    return _pack_level_cuda(feat, num_groups)


pack_level.launches = 0  # kernel launches (counted in _pack_level_cuda)

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("msmv_pack")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.msmv_pack_level.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.msmv_pack_level.restype = ci
        _SIGNATURE_SET = True
    return lib


def _pack_level_cuda(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    if not feat.is_cuda:
        raise ValueError(f"pack_level: no kernel for device {feat.device}")
    if feat.dim() != 4:
        raise ValueError(f"pack_level: feat must be [M, H, W, C], got "
                         f"{tuple(feat.shape)}")
    if not feat.is_contiguous():
        raise ValueError("pack_level: feat must be contiguous")
    m, h, w, c = feat.shape
    g = num_groups
    if c % g:
        raise ValueError(f"pack_level: C={c} is not divisible by G={g}")
    cg = c // g
    out = torch.empty((m, h, g, w + 1, 2 * cg), dtype=feat.dtype,
                      device=feat.device)
    half_row = cg * feat.element_size()
    vec = next((v for v in (16, 8, 4, 2)
                if half_row % v == 0 and feat.data_ptr() % v == 0
                and out.data_ptr() % v == 0), None)
    if vec is None:
        raise ValueError(f"pack_level: a {half_row}-byte half-row has no "
                         "2/4/8/16-byte vector width")
    lib = _lib()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = lib.msmv_pack_level(feat.data_ptr(), out.data_ptr(), m, h, w, g,
                                 half_row, vec, stream)
    build.check(lib, "msmv_pack", rc)
    pack_level.launches += 1
    return out
