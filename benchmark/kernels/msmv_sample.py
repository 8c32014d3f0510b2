"""The sampling forward (``csrc/msmv_sample.cu``, ``msmv_sample_kernel``).

Bytes: every table piece the points touch with a nonzero weight, read once
at its level's item size; the locations, weights and slice map read once;
the output ``[Q, S, P, C]`` written once in its dtype. Operations: 12 fp32
operations a channel for each (point, level): four taps, each a product and
a sum, and the level weight's product and sum (the port's PERF.md bound).
"""

from harness.pieces import geometry, io_bytes, touched

HOOK = ("sparsebev_tpu_torch.ops.msmv_sampling", "_msmv_sampling_cuda")
KERNEL = "msmv_sample_kernel<"
RATE = "fp32_flops_per_s"


def record(args, out):
    packed, loc, sw = args[:3]
    return geometry(packed), loc, sw, out.numel() * out.element_size()


def count(rec):
    import torch
    geo, loc, sw, out_bytes = rec
    k = loc[..., 0].numel()
    table = sum(n * b for n, b in touched(torch, geo, loc, sw))
    flops = 12 * k * len(geo.level_shapes) * geo.channels
    return flops, table + io_bytes(geo, loc, sw) + out_bytes
