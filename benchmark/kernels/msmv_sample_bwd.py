"""The sampling backward (``csrc/msmv_sample_bwd.cu``,
``msmv_sample_bwd_kernel``).

Bytes: every touched table piece read once, and, when the call adds a
table gradient, that piece's gradient read and written once, in the table
dtype; the output gradient, locations, weights and slice map read once; the
location and weight gradients written once in fp32. Operations: 16 a
channel for each (point, level): for each of four taps the table
gradient's product and sum and the weights' product and sum.
"""

from harness.pieces import geometry, io_bytes, touched

HOOK = ("sparsebev_tpu_torch.ops.msmv_sampling",
        "_msmv_sampling_backward_cuda")
KERNEL = "msmv_sample_bwd_kernel<"
RATE = "fp32_flops_per_s"


def record(args, out):
    packed, loc, sw, grad_out = args[:4]
    grads = args[4] if len(args) > 4 else None
    d_loc, d_sw = out
    return (geometry(packed), loc, sw,
            grad_out.numel() * grad_out.element_size(), grads is not None,
            (d_loc.numel() + d_sw.numel()) * 4)


def count(rec):
    import torch
    geo, loc, sw, gout_bytes, with_table_grad, dgrad_bytes = rec
    k = loc[..., 0].numel()
    per_piece = 3 if with_table_grad else 1
    table = sum(n * b * per_piece for n, b in touched(torch, geo, loc, sw))
    flops = 16 * k * len(geo.level_shapes) * geo.channels
    return flops, (table + io_bytes(geo, loc, sw) + gout_bytes
                   + dgrad_bytes)
