"""Fused adaptive-mixing core, ``relu(LN2d(s @ relu(LN2d(x @ m))))``.

Counterpart of ``sparsebev_tpu/ops/mixing_pallas.py``. One CUDA source,
``csrc/mixing.cu``, replaces both TPU kernels: ``mixing_core_tpu`` (:74,
two-pass LN statistics) through :func:`mixing_core`, and
``mixing_core_tpu_batched`` (:160, one-pass statistics) through
:func:`mixing_core_batched`. :func:`mixing_core_plain` is the plain PyTorch
version of both; its two-pass form is ``_mixing_core_xla`` (:196-210).

Shapes: ``x [BQ, G, P, C]``, ``m [BQ, G, C, C]``, ``s [BQ, G, O, P]`` ->
``[BQ, G, O, C]`` in x's dtype. Both products are kept in fp32 up to each
LN (fp32 statistics, eps 1e-5); h1 is rounded to the input dtype before the
second product.

As in the JAX package, the decoder does not call it: its bf16 matmuls round
``x @ m`` and ``s @ h1`` to bf16 before each LN
(``models/decoder.py::AdaptiveMixing``), which these ops do not, so wiring
them in would change the main path's bits against the reference.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from .autograd_guard import refuse_backward

EPS = 1e-5


def _ln2d(t: torch.Tensor, stats: str) -> torch.Tensor:
    """Parameter-free LN over the trailing two dims of fp32 ``t``."""
    n = t.shape[-1] * t.shape[-2]
    if stats == "twopass":       # mean((t - mu)^2): jnp.mean / jnp.var
        mu = t.sum(dim=(-2, -1), keepdim=True) / n
        d = t - mu
        var = (d * d).sum(dim=(-2, -1), keepdim=True) / n
    elif stats == "onepass":     # max(E[t^2] - E[t]^2, 0): the batched kernel
        mu = t.sum(dim=(-2, -1), keepdim=True) / n
        sq = (t * t).sum(dim=(-2, -1), keepdim=True) / n
        var = (sq - mu * mu).clamp(min=0.0)
    else:
        raise ValueError(f"unknown LN statistics {stats!r}")
    return (t - mu) * torch.rsqrt(var + EPS)


def mixing_core_plain(x: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                      stats: str = "twopass") -> torch.Tensor:
    """Plain PyTorch version: fp32 products of the inputs, LN statistics
    ``"twopass"`` (``_mixing_core_xla``, ``mixing_core_tpu``) or
    ``"onepass"`` (``mixing_core_tpu_batched``)."""
    h1 = torch.matmul(x.float(), m.float())
    h1 = torch.relu(_ln2d(h1, stats)).to(x.dtype)
    h2 = torch.matmul(s.float(), h1.float())
    return torch.relu(_ln2d(h2, stats)).to(x.dtype)


class _MixingCore(torch.autograd.Function):
    """Forward: the two-pass kernel (the plain version for CPU tensors).
    Backward: autograd of the plain two-pass version, as the JAX custom VJP
    (``_mixing_core_bwd`` :224-227) re-derives through ``_mixing_core_xla``;
    the JAX package has no backward kernel."""

    @staticmethod
    def forward(ctx, x, m, s):
        ctx.save_for_backward(x, m, s)
        if x.device.type == "cpu":
            return mixing_core_plain(x, m, s)
        return _mixing_cuda(x, m, s, two_pass=True)

    @staticmethod
    def backward(ctx, grad):
        x, m, s = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, m, s)]
            out = mixing_core_plain(*leaves)
            return torch.autograd.grad(out, leaves, grad.to(x.dtype))


def mixing_core(x: torch.Tensor, m: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """The mixing chain with two-pass LN statistics, differentiable. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises)."""
    return _MixingCore.apply(x, m, s)


mixing_core.launches = 0  # kernel launches (counted in _mixing_cuda)


def mixing_core_batched(x: torch.Tensor, m: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """The mixing chain with one-pass LN statistics, forward only (as
    ``mixing_core_tpu_batched``). A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return mixing_core_plain(x, m, s, stats="onepass")
    return _mixing_cuda(x, m, s, two_pass=False)


mixing_core_batched.launches = 0  # kernel launches (in _mixing_cuda)

# the tensor-core kernel of csrc/mixing.cu: mma.sync tiles are 16 deep, and
# it is instantiated for the decoder's group width and out points
_MMA_TILE = 16
_MMA_CHANNELS = 64
_MMA_OUT_POINTS = 128
_MMA_MAX_POINTS = 64


def padded_points(p: int) -> int:
    """``p`` in-points rounded up to the tensor-core tile depth: the rows
    of ``x @ m`` and the depth of ``s @ h1`` that the kernel computes. The
    padding is zeros in the second product and stays out of both LNs, whose
    statistics run over exactly ``p * C`` and ``O * C`` values."""
    if p < 1:
        raise ValueError(f"mixing_core: {p} in-points")
    return -(-p // _MMA_TILE) * _MMA_TILE


def mixing_route(dtype: torch.dtype, p: int, c: int, o: int) -> str:
    """Which kernel of ``csrc/mixing.cu`` takes these operands: ``"mma"``
    (bf16 tensor cores, asynchronous copies) for bf16 at ``C = 64``,
    ``O = 128`` and an even ``P <= 64`` (a row of ``s`` must be a whole
    number of 4-byte copies), else ``"fma"`` (fp32 FMA loops: fp32 inputs
    keep full fp32, and bf16 at other shapes)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"mixing_core: no kernel for {dtype}")
    if dtype == torch.bfloat16 and c == _MMA_CHANNELS \
            and o == _MMA_OUT_POINTS and p % 2 == 0 \
            and padded_points(p) <= _MMA_MAX_POINTS:
        return "mma"
    return "fma"

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("mixing")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.mixing_core_twopass, lib.mixing_core_onepass):
            fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci,
                           ci, ctypes.c_float, vp]
            fn.restype = ci
        _SIGNATURE_SET = True
    return lib


def _mixing_cuda(x, m, s, two_pass: bool) -> torch.Tensor:
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"mixing_core: no kernel for device {dev}")
    # mixing_core launches from inside its autograd Function (grad mode off
    # there); the batched entry has no backward and must not cut a gradient
    refuse_backward("mixing_core_batched", [x, m, s])
    if x.dim() != 4 or m.dim() != 4 or s.dim() != 4:
        raise ValueError("mixing_core: x, m, s must be [BQ, G, P, C], "
                         "[BQ, G, C, C], [BQ, G, O, P]")
    bq, g, p, c = x.shape
    o = s.shape[2]
    if tuple(m.shape) != (bq, g, c, c) or tuple(s.shape) != (bq, g, o, p):
        raise ValueError(f"mixing_core: shapes {tuple(x.shape)}, "
                         f"{tuple(m.shape)}, {tuple(s.shape)} do not chain")
    route = mixing_route(x.dtype, p, c, o)
    for name, t in (("x", x), ("m", m), ("s", s)):
        if t.dtype != x.dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"mixing_core: {name} must be contiguous "
                             f"{x.dtype} on {dev}")
    out = torch.empty((bq, g, o, c), dtype=x.dtype, device=dev)
    if route == "mma" and any(t.data_ptr() % 16 for t in (x, m, s, out)):
        raise ValueError("mixing_core: operands must be 16-byte aligned")
    padded = padded_points(p) if route == "mma" else 0
    lib = _lib()
    fn = lib.mixing_core_twopass if two_pass else lib.mixing_core_onepass
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), m.data_ptr(), s.data_ptr(), out.data_ptr(),
                bq * g, p, c, o, int(x.dtype == torch.bfloat16), padded,
                EPS, stream)
    build.check(lib, "mixing", rc)
    if two_pass:
        mixing_core.launches += 1
    else:
        mixing_core_batched.launches += 1
    return out
