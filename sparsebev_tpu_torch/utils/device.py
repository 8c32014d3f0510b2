"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device that is not available raises; the
    CPU (the plain PyTorch versions of the kernels) only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the sparsebev_tpu_torch entry points run "
            "on the GPU by default (pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU)")
    return dev
