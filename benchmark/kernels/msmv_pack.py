"""The y-fold pack
(``csrc/msmv_pack.cu``, ``pack_yfold_kernel``):
``[M, H, W, C] -> [M, H, G, W+1, 2Cg]``.

Bytes: the input read once and the output written once, each in its
dtype. Operations: none counted (a copy; the adjoint's one add an element
is not worth a bound)."""

HOOK = ("sparsebev_tpu_torch.ops.msmv_pack", "_pack_level_cuda")
KERNEL = "pack_yfold_kernel<"
RATE = "fp32_flops_per_s"


def record(args, out):
    src = args[0]
    return (src.numel() * src.element_size(),
            out.numel() * out.element_size())


def count(rec):
    return 0, rec[0] + rec[1]
