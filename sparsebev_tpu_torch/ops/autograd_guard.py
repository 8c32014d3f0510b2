"""Keep forward-only kernels out of a gradient.

Some CUDA kernels of the port have no backward kernel because their JAX
functions define no VJP either (the one-hot samplers, the tap-fold epilogue,
the batched mixing core). A wrapper that launched such a kernel on operands
that require grad would return a tensor without ``grad_fn`` and the
gradient would silently stop there. Those wrappers call
:func:`refuse_backward` on their CUDA branch instead. (On CPU tensors the
plain PyTorch versions run, and autograd differentiates those.)
"""

from __future__ import annotations

import torch


def _tensors(items):
    for item in items:
        if isinstance(item, torch.Tensor):
            yield item
        elif isinstance(item, (list, tuple)):
            yield from _tensors(item)


def refuse_backward(op: str, operands) -> None:
    """Raise if autograd is recording and any tensor among ``operands`` (a
    nested list / tuple; ``None`` entries are skipped) requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in _tensors(operands)):
        raise RuntimeError(
            f"{op} has no backward kernel (its JAX function defines no VJP): "
            "call it under torch.no_grad() / inference_mode(), or detach its "
            "operands")
