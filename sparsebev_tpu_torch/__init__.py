"""SparseBEV in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``sparsebev_tpu`` (which stays the reference).
Its layout mirrors the JAX package: ``ops/`` (geometry, the y-fold pack and
the multi-scale multi-view sampling op), ``models/`` (ResNet, FPN, the
SparseBEV decoder and head), ``bbox/`` (the NMS-free coder), ``inference.py``
(streaming inference with a device-side table ring) and ``config.py``.

Modules import ``torch`` only; nothing here imports ``jax`` or the JAX
package. CUDA kernels live in ``csrc/`` and are built with ``nvcc`` at first
use into ``build/`` (see ``kernels/build.py``).
"""
