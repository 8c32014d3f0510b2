"""Device choice for the port's entry points (CUDA unless the caller asks
for the CPU), and the fp32 precision scope of its backbones."""

from __future__ import annotations

import contextlib

import torch



@contextlib.contextmanager
def fp32_precision():
    """fp32 convolutions and matrix products in full fp32 for the duration,
    whatever the process-wide settings say; the settings are restored after.

    On CUDA, cuDNN runs fp32 convolutions in TF32 (a 10-bit mantissa) while
    ``torch.backends.cudnn.conv.fp32_precision`` is "tf32", PyTorch's
    default, and cuBLAS runs fp32 matrix products in TF32 when
    ``torch.backends.cuda.matmul.fp32_precision`` is "tf32". The JAX package
    and the port's CPU tests compute both in fp32, so the port's backbones,
    necks and the EVA02 trunk run inside this scope
    (``SparseBEV.extract_img_feat``, the train step's backward). It sets
    both to "ieee" through the per-backend settings of torch 2.9 and later,
    never through the legacy ``allow_tf32`` flags or
    ``set_float32_matmul_precision``, whose getters raise once a caller has
    mixed the two APIs (inside the scope, read the per-backend settings).
    bf16 convolutions and products read neither."""
    settings = (torch.backends.cudnn.conv, torch.backends.cuda.matmul)
    saved = [s.fp32_precision for s in settings]
    for s in settings:
        s.fp32_precision = "ieee"
    try:
        yield
    finally:
        for s, value in zip(settings, saved):
            s.fp32_precision = value
