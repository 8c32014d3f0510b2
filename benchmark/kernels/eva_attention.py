"""The EVA02 attention forward (``csrc/eva_attention.cu``,
``eva_attention_kernel``).

Operations: the two products, 4 B H N^2 d for ``[B, N, H, d]`` operands
(q k^T and P v, a multiply and an add each), counted once whatever
implements them: 393.2 GFLOP a global call (6 x 4,000 tokens, 16 x 64) and
33.8 GFLOP a windowed call (126 x 256 tokens). The rate is the dense TF32
peak: a product that the configuration keeps in fp32 runs on the tensor
cores at most at that rate, so no implementation at this precision reads
above 100%. Bytes: q, k and v read once and the output written once, in
their dtype, and the rows' log-sum-exp (fp32) where the call writes it."""

HOOK = ("sparsebev_tpu_torch.ops.eva_attention", "_eva_attention_cuda")
KERNEL = "eva_attention_kernel"
RATE = "tf32_flops_per_s"


def record(args, out):
    q = args[0]
    lse = out[1]
    return (tuple(q.shape), q.element_size(),
            0 if lse is None else lse.numel() * lse.element_size())


def count(rec):
    (b, n, h, d), item, lse_bytes = rec
    return 4 * b * h * n * n * d, 4 * b * n * h * d * item + lse_bytes
