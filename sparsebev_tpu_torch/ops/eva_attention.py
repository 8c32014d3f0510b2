"""Softmax attention of the EVA02 ViT's windowed and global blocks, and its
gradient.

Counterpart of the ``jax.nn.dot_product_attention`` calls of
``sparsebev_tpu/models/eva02.py::EvaAttention`` (:182; directly for the
windowed blocks at :213, and through ``_chunked_attention`` :151 for the
global ones at :175), and of ``jax.grad`` through them in the training
step: the CUDA kernels of ``csrc/eva_attention.cu`` (forward, and a
backward of three kernels), and :func:`eva_attention_plain` /
:func:`eva_attention_backward_plain` beside them.

Layout ``[B, N, heads, hd]`` as in JAX. The plain version follows
``_dot_product_attention_core``: logits in fp32 scaled by ``hd ** -0.5``,
softmax in fp32, the probabilities cast to the value dtype, then the
product with v. Above :data:`CHUNK_ABOVE` tokens it takes the queries
:data:`CHUNK` at a time, as ``_chunked_attention`` does above
``EvaAttention.chunk_above``: softmax runs over the keys, so this changes
no value and bounds the score buffer (6 views x 16 heads x 4000^2 fp32 is
6.1 GB unchunked, 0.8 GB a chunk). The kernel keeps no scores in device
memory (online softmax) and takes fp32 ``[B, N, 16, 64]`` operands, as the
EVA02 trunk gives them; it normalises at the end rather than before the
product with v, so it differs from the plain version by fp32 rounding.

Gradients: on a CUDA tensor that autograd records, :func:`eva_attention`
goes through :class:`EvaAttentionFunction`, whose forward launches the
kernel with the rows' log-sum-exp and whose backward launches the backward
kernel (``dq, dk, dv`` from ``q, k, v``, the output, the log-sum-exp and
the output's gradient; no score matrix in device memory). On the CPU
:func:`eva_attention` is the plain forward, which autograd differentiates;
the Function takes :func:`eva_attention_lse_plain` and
:func:`eva_attention_backward_plain` there.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

CHUNK_ABOVE = 2048      # EvaAttention.chunk_above
CHUNK = 512             # _chunked_attention's query chunk
HEAD_DIM = 64           # the kernel's one head dim

# the kernel against its plain version: both products in 3xTF32 (about
# 2^-21 of each product's size) against fp32 products, summed in another
# order, and the division by the softmax sum taken at the end instead of
# before the product with v: a few fp32 roundings of values up to the output
# scale, hence 1e-5 of the output's max abs (one TF32 product a k-step would
# land at 4e-4 - 7e-4 of it: tests/test_torch_kernel_layouts.py)
ATTENTION_TOL = 1e-5
# the backward kernel against its plain version, each of dq, dk and dv
# within this share of its own max abs: five 3xTF32 products where the
# plain version takes fp32 ones, P recomputed from the forward's
# log-sum-exp, and dS = P (dP - D) cancelling where dP is near the row's D,
# which lifts the products' rounding against the gradient's scale; twice
# the forward's tolerance (a CPU replay of the kernels' order lands within
# 2.1e-6 of each gradient's scale at N = 200 and 300, one TF32 product a
# k-step 6e-4 - 1e-3 away: tests/test_torch_kernel_layouts.py)
ATTENTION_BWD_TOL = 2e-5


def _check(q, k, v):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError("eva_attention: q, k and v must share one "
                         f"[B, N, heads, hd] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _chunks(n):
    """The query ranges of one plain call: all N at once up to
    :data:`CHUNK_ABOVE`, else :data:`CHUNK` at a time."""
    if n <= CHUNK_ABOVE:
        return [(0, n)]
    return [(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]


def _logits(q, k):
    """fp32 logits ``[B, heads, Nq, Nk]`` scaled by ``hd ** -0.5``."""
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float())
    return logits * q.shape[-1] ** -0.5


def _attention_core(q, k, v):
    probs = torch.softmax(_logits(q, k), dim=-1).to(k.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def eva_attention_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (see the module docstring)."""
    _check(q, k, v)
    return torch.cat([_attention_core(q[:, a:b], k, v)
                      for a, b in _chunks(q.shape[1])], dim=1)


def eva_attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The rows' log-sum-exp of the scaled fp32 logits, ``[B, heads, N]``
    fp32 (what the kernel writes beside its output for the backward)."""
    return torch.cat([torch.logsumexp(_logits(q[:, a:b], k), dim=-1)
                      for a, b in _chunks(q.shape[1])], dim=-1)


def eva_attention_backward_plain(q, k, v, o, lse, dout):
    """Plain PyTorch version of the backward: ``(dq, dk, dv)`` of the
    attention at ``q, k, v`` (``[B, N, heads, hd]``) given its output ``o``,
    the rows' log-sum-exp ``lse`` (``[B, heads, N]``) and the output's
    gradient ``dout``, by the explicit formula in fp32 (the queries in
    chunks above :data:`CHUNK_ABOVE`, as the forward):
    ``D = rowsum(dout * o)``, ``P = exp(S - lse)``, ``dv = P^T dout``,
    ``dS = P * (dout v^T - D)``, ``dq = dS k / 8``, ``dk = dS^T q / 8``
    (``hd ** -0.5`` for 1/8). Returned in the operands' dtype."""
    _check(q, k, v)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, dout))
    scale = q.shape[-1] ** -0.5
    delta = (gf * of).sum(-1).permute(0, 2, 1)          # [B, heads, N]
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for a, b in _chunks(q.shape[1]):
        p = torch.exp(_logits(qf[:, a:b], kf) - lse[..., a:b, None].float())
        g = gf[:, a:b]
        dv += torch.einsum("bnts,btnh->bsnh", p, g)
        dp = torch.einsum("btnh,bsnh->bnts", g, vf)
        ds = p * (dp - delta[..., a:b, None])
        dq[:, a:b] = torch.einsum("bnts,bsnh->btnh", ds, kf) * scale
        dk += torch.einsum("bnts,btnh->bsnh", ds, qf[:, a:b]) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def eva_attention(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """``[B, N, heads, hd]`` attention output. CPU tensors take the plain
    version (autograd differentiates it); CUDA tensors launch the kernel (or
    raise), through :class:`EvaAttentionFunction` while autograd records a
    tensor that requires grad."""
    if q.device.type == "cpu":
        return eva_attention_plain(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return EvaAttentionFunction.apply(q, k, v)
    return _eva_attention_cuda(q, k, v)[0]


eva_attention.launches = 0  # forward kernel launches (_eva_attention_cuda)


def eva_attention_backward(q, k, v, o, lse, dout):
    """``(dq, dk, dv)`` (see :func:`eva_attention_backward_plain`): the
    backward kernel on CUDA tensors (or raise), the plain version on CPU
    ones."""
    if q.device.type == "cpu":
        return eva_attention_backward_plain(q, k, v, o, lse, dout)
    return _eva_attention_backward_cuda(q, k, v, o, lse, dout)


eva_attention_backward.launches = 0  # (counted in _eva_attention_backward_cuda)


class EvaAttentionFunction(torch.autograd.Function):
    """The attention with its backward kernel: the forward keeps ``q, k,
    v``, the output and the rows' log-sum-exp (``[B, heads, N]`` fp32); the
    backward returns ``dq, dk, dv`` from them (the kernels on CUDA tensors,
    the plain versions on CPU ones)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out, lse = eva_attention_plain(q, k, v), \
                eva_attention_lse_plain(q, k)
        else:
            out, lse = _eva_attention_cuda(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return eva_attention_backward(q, k, v, out, lse, dout.contiguous())


_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("eva_attention")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.eva_attention_forward.argtypes = [vp] * 5 + [ci] * 4 + [vp]
        lib.eva_attention_forward.restype = ci
        lib.eva_attention_backward.argtypes = [vp] * 10 + [ci] * 4 + [vp]
        lib.eva_attention_backward.restype = ci
        _SIGNATURE_SET = True
    return lib


def _check_cuda(op, tensors, shape):
    """The kernels' operands: fp32, contiguous, 16-byte aligned, on the
    first tensor's CUDA device, ``[B, N, heads, 64]`` with B and heads in
    the grid's range."""
    dev = tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError(f"{op}: no kernel for device {dev}")
    b, n, heads, hd = shape
    if hd != HEAD_DIM:
        raise ValueError(f"{op}: the kernel takes head dim {HEAD_DIM}, got "
                         f"{hd}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{op}: the kernel takes fp32, got {t.dtype}")
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: every operand must be contiguous, "
                             f"16-byte aligned, on {dev}")
    if not 0 < b <= 65535 or not 0 < heads <= 65535 or n <= 0:
        raise ValueError(f"{op}: no launch for shape {tuple(shape)}")


def _eva_attention_cuda(q, k, v, with_lse=False):
    """``(out, lse)``: one launch of the forward kernel; lse (``[B, heads,
    N]`` fp32) only ``with_lse``, else None."""
    _check(q, k, v)
    _check_cuda("eva_attention", (q, k, v), q.shape)
    b, n, heads, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.eva_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, n, heads, hd, stream)
    build.check(lib, "eva_attention", rc)
    eva_attention.launches += 1
    return out, lse


def _eva_attention_backward_cuda(q, k, v, o, lse, dout):
    """One call of the backward entry (three kernels: D, dK / dV, dQ), its
    D scratch allocated here."""
    _check(q, k, v)
    b, n, heads, hd = q.shape
    if tuple(o.shape) != tuple(q.shape) or \
            tuple(dout.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (b, heads, n):
        raise ValueError("eva_attention_backward: out and dout must be "
                         f"{tuple(q.shape)} and lse {(b, heads, n)}")
    _check_cuda("eva_attention_backward", (q, k, v, o, lse, dout), q.shape)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.eva_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, n, heads, hd, stream)
    build.check(lib, "eva_attention", rc)
    eva_attention_backward.launches += 1
    return dq, dk, dv
