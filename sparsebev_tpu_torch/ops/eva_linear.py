"""The EVA02 trunk's dense fp32 products, ``y = x W^T + b``.

Counterpart of the JAX trunk's ``Linear`` layers
(``sparsebev_tpu/models/eva02.py:144-148``, SwiGLU's w1 / w2 / w3, and
``:199-215``, ``EvaAttention``'s q / k / v projections and ``proj``), which
XLA computes in fp32: the CUDA kernel of ``csrc/eva_linear.cu`` (3xTF32 on
the tensor cores, ``wgmma``), and ``F.linear`` beside it as the plain
version. CPU tensors take ``F.linear`` as it is; a CUDA tensor launches the
kernel or raises.

Gradients: on a CUDA tensor that autograd records, :func:`eva_linear` goes
through :class:`EvaLinearFunction`, whose forward launches the kernel and
whose backward takes the plain fp32 products autograd of ``F.linear``
computes (``dY W``, ``dY^T x``, the sum of ``dY``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build

# the kernel against the fp64 product, as a share of the output's max abs:
# 3xTF32 (about 2^-21 of each product) with the wgmma accumulator truncating
# each sum and promoted into fp32 registers every 16 k-steps. A CPU replay of
# that order at K = 1024 and 2730 lands 1.1e-6 - 1.5e-6 from it, one
# unpromoted accumulator over all of K 1.3e-5 - 2.1e-5 and one TF32 product
# a k-step 6.6e-4 - 7.7e-4 (tests/test_torch_eva_linear.py); on an H100 the
# kernel reads 1.3e-6 - 1.5e-6 at the trunk's shapes and fp32 F.linear
# 6e-7 - 2.3e-6 (chip_smoke.py's linear phase)
LINEAR_TOL = 4e-6


def _check(x, weight, bias):
    """The operands of one call: fp32, contiguous, on one device, ``x``
    ``[..., K]``, ``weight`` ``[N, K]``, ``bias`` ``[N]`` or None."""
    ops = (x, weight) if bias is None else (x, weight, bias)
    for t in ops:
        if t.dtype != torch.float32:
            raise ValueError(f"eva_linear: fp32 operands only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("eva_linear: every operand must be contiguous")
        if t.device != x.device:
            raise ValueError("eva_linear: the operands lie on "
                             f"{x.device} and {t.device}")
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError("eva_linear: x [..., K] and weight [N, K] must share "
                         f"K, got {tuple(x.shape)} and {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"eva_linear: bias must be [{weight.shape[0]}], got "
                         f"{tuple(bias.shape)}")


def eva_linear(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor = None) -> torch.Tensor:
    """``x @ weight.T + bias`` (``[..., N]``). CPU tensors take
    ``F.linear``; CUDA tensors launch the kernel (or raise), through
    :class:`EvaLinearFunction` while autograd records a tensor that
    requires grad."""
    _check(x, weight, bias)
    eva_linear.calls += 1
    if x.device.type == "cpu":
        return F.linear(x, weight, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return EvaLinearFunction.apply(x, weight, bias)
    return _eva_linear_cuda(x, weight, bias)


eva_linear.calls = 0     # calls on any device
eva_linear.launches = 0  # kernel launches (_eva_linear_cuda)


class EvaLinearFunction(torch.autograd.Function):
    """The product with the kernel in its forward (``F.linear`` on the CPU)
    and the plain fp32 products of ``F.linear``'s gradient in its
    backward."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if x.device.type == "cpu":
            return F.linear(x, weight, bias)
        return _eva_linear_cuda(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy2 = dy.reshape(-1, weight.shape[0])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dy2.mm(weight).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = dy2.t().mm(x.reshape(-1, weight.shape[1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy2.sum(0)
        return dx, dw, db


_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("eva_linear")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.eva_linear_forward.argtypes = [vp] * 4 + [ci] * 3 + [vp]
        lib.eva_linear_forward.restype = ci
        lib.eva_linear_route.argtypes = [vp, vp, ci]
        lib.eva_linear_route.restype = ci
        lib.eva_linear_smem_bytes.argtypes = []
        lib.eva_linear_smem_bytes.restype = ci
        _SIGNATURE_SET = True
    return lib


def load_route(x, weight):
    """How the kernel loads these operands: ``"tma"`` (K a multiple of 4,
    both 16-byte aligned) or ``"cp.async"`` (8-byte pieces); None where it
    takes neither (builds the library)."""
    route = _lib().eva_linear_route(x.data_ptr(), weight.data_ptr(),
                                    weight.shape[1])
    return {1: "tma", 0: "cp.async"}.get(route)


def kernel_smem_bytes():
    """Dynamic shared memory of ``eva_linear_kernel``, bytes (builds the
    library)."""
    return _lib().eva_linear_smem_bytes()


def _eva_linear_cuda(x, weight, bias=None):
    """One launch of the kernel into a fresh ``[..., N]`` output."""
    _check(x, weight, bias)
    if not x.is_cuda:
        raise ValueError(f"eva_linear: no kernel for device {x.device}")
    n, k = weight.shape
    m = x.numel() // k if k else 0
    y = torch.empty((*x.shape[:-1], n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    if k % 2 or n % 2 or m >= 2**31 or any(
            t.data_ptr() % 8 for t in (x, weight, y)
            + (() if bias is None else (bias,))):
        raise ValueError("eva_linear: the kernel takes an even K and N, "
                         "8-byte aligned operands and M below 2^31, got "
                         f"M={m} N={n} K={k}")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.eva_linear_forward(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k,
            stream)
    build.check(lib, "eva_linear", rc)
    eva_linear.launches += 1
    return y
