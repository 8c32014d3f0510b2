"""The plain reference that decides ``correct``: SparseBEV in plain PyTorch.

A frozen copy of the plain path of the port (``sparsebev_tpu_torch`` at
commit 6b78e2d): the detector, the ResNet / VoVNet backbones and FPN, the
packed-table sampling and the streaming ring, the head and decoder, the
losses with the matcher, the training step and AdamW, and the NMS-free
coder. It launches no kernel and imports nothing of the port, of the JAX
package or of JAX. The seeded head amplifies a one-ulp change of its input
far past any useful tolerance (PERF.md, fault 1), so the copy keeps the
port's order of floating-point operations on the forward path.
"""
