"""Softmax attention of the EVA02 ViT's windowed and global blocks.

Counterpart of the ``jax.nn.dot_product_attention`` calls of
``sparsebev_tpu/models/eva02.py::EvaAttention`` (:182; directly for the
windowed blocks at :213, and through ``_chunked_attention`` :151 for the
global ones at :175): the CUDA kernel ``csrc/eva_attention.cu``, and
:func:`eva_attention_plain` beside it.

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
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from .autograd_guard import refuse_backward

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


def _check(q, k, v):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError("eva_attention: q, k and v must share one "
                         f"[B, N, heads, hd] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _attention_core(q, k, v):
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float())
    logits = logits * q.shape[-1] ** -0.5
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def eva_attention_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (see the module docstring)."""
    _check(q, k, v)
    n = q.shape[1]
    if n <= CHUNK_ABOVE:
        return _attention_core(q, k, v)
    return torch.cat([_attention_core(q[:, i:i + CHUNK], k, v)
                      for i in range(0, n, CHUNK)], dim=1)


def eva_attention(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """``[B, N, heads, hd]`` attention output. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return eva_attention_plain(q, k, v)
    return _eva_attention_cuda(q, k, v)


eva_attention.launches = 0  # kernel launches (counted in _eva_attention_cuda)

_SIGNATURE_SET = False


def _lib():
    global _SIGNATURE_SET
    lib = build.load("eva_attention")
    if not _SIGNATURE_SET:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.eva_attention_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                              vp]
        lib.eva_attention_forward.restype = ci
        _SIGNATURE_SET = True
    return lib


def _eva_attention_cuda(q, k, v):
    dev = q.device
    if not q.is_cuda:
        raise ValueError(f"eva_attention: no kernel for device {dev}")
    refuse_backward("eva_attention", [q, k, v])
    _check(q, k, v)
    b, n, heads, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"eva_attention: the kernel takes head dim "
                         f"{HEAD_DIM}, got {hd}")
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise ValueError(f"eva_attention: the kernel takes fp32, got "
                             f"{t.dtype}")
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("eva_attention: q, k and v must be contiguous, "
                             f"16-byte aligned, on {dev}")
    if not 0 < b <= 65535 or not 0 < heads <= 65535 or n <= 0:
        raise ValueError(f"eva_attention: no launch for shape "
                         f"{tuple(q.shape)}")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.eva_attention_forward(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), b, n,
                                       heads, hd, stream)
    build.check(lib, "eva_attention", rc)
    eva_attention.launches += 1
    return out
