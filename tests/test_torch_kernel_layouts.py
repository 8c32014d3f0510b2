"""What the H100 redesigns of the sampling forward, the one-hot sampler and
the mixing core keep in Python, where the CPU reaches it: how many lanes of a
warp share a sampling point (and which channel counts and tables the
16-byte-lane kernels refuse), how many levels one launch of the fused
one-hot kernel takes, how the mixing wrapper pads the in-points to the tensor-core tile and which
of its three kernels it picks, and the padding scheme the tensor-core kernel
relies on, replayed with plain PyTorch: operands padded from P to the next
kernel width give the unpadded result when the first LN's statistics run
over the P real rows only and the padded rows of h1 are zero; and the fp32
route's 3xTF32 order (``mixing_tf32_kernel``), replayed with truncating
accumulators, within ``MIXING_TOL["float32"]`` of the plain version and of
JAX, where one TF32 product a k-step lands fifty times outside it.

Tolerance of the padded replay: the padded products sum the same fp32
terms plus exact zeros, in whatever order the matmul picks for the longer
depth, so fp32 agrees within 1e-5 of the output scale."""

import os

import numpy as np
import pytest
import torch

from sparsebev_tpu_torch.ops import mixing
from sparsebev_tpu_torch.ops.eva_attention import ATTENTION_TOL
from sparsebev_tpu_torch.ops.mixing import (mixing_core_plain, mixing_route,
                                            padded_points)
from sparsebev_tpu_torch.ops import msmv_onehot
from sparsebev_tpu_torch.ops.msmv_onehot import onehot_lanes_per_point
from sparsebev_tpu_torch.ops.msmv_sampling import (sample_lanes_per_point,
                                                   sample_table_dtypes)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("channels,dtype,lanes", [
    (64, torch.bfloat16, 8),      # every config: 4 points a warp
    (64, torch.float32, 16),      # 2 points a warp
    (256, torch.bfloat16, 32),    # one point a warp
    (128, torch.float32, 32),
    (24, torch.bfloat16, 4),      # 3 runs of 16 bytes: 4 lanes, one idle
    (8, torch.bfloat16, 1),
])
def test_sampling_lanes_per_point(channels, dtype, lanes):
    assert sample_lanes_per_point(channels, dtype) == lanes
    assert lanes * 16 >= channels * dtype.itemsize and 32 % lanes == 0


@pytest.mark.parametrize("channels,dtype,match", [
    (63, torch.bfloat16, "multiple of 16"),
    (6, torch.float32, "multiple of 16"),
    (0, torch.float32, "multiple of 16"),
    (256, torch.float32, "more than the 32 lanes"),
    (512, torch.bfloat16, "more than the 32 lanes"),
    (64, torch.float16, "no kernel for torch.float16"),
])
def test_sampling_kernel_refuses(channels, dtype, match):
    with pytest.raises(ValueError, match=match):
        sample_lanes_per_point(channels, dtype)


@pytest.mark.parametrize("dtypes,lanes", [
    # an e4m3 level keeps a bf16 lane's 8 channels (8 bytes read a lane)
    ((torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16), 8),
    ((torch.bfloat16, torch.float8_e4m3fn), 8),
    # beside fp32 levels an fp32 lane's 4 channels (4 bytes read a lane)
    ((torch.float8_e4m3fn, torch.float32, torch.float32), 16),
    ((torch.float32, torch.float8_e4m3fn), 16),
    ((torch.float8_e4m3fn,), 8),            # an all-e4m3 ring reads as bf16
    (torch.float8_e4m3fn, 8),
    ((torch.float32,) * 5, 16),
])
def test_sampling_e4m3_lane_map(dtypes, lanes):
    assert sample_lanes_per_point(64, dtypes) == lanes
    base, fp8 = sample_table_dtypes(dtypes)
    seq = (dtypes,) if isinstance(dtypes, torch.dtype) else dtypes
    assert fp8 == tuple(d == torch.float8_e4m3fn for d in seq)
    assert base == (torch.float32 if torch.float32 in seq
                    else torch.bfloat16)


@pytest.mark.parametrize("dtypes,match", [
    ((torch.float8_e4m3fn, torch.float32, torch.bfloat16),
     "tables of one dtype"),
    ((torch.bfloat16, torch.float32), "tables of one dtype"),
    ((torch.float8_e4m3fn, torch.float16), "no kernel for torch.float16"),
    ((torch.float8_e5m2, torch.bfloat16), "tables of one dtype"),
])
def test_sampling_kernel_refuses_e4m3_mixes(dtypes, match):
    with pytest.raises(ValueError, match=match):
        sample_lanes_per_point(64, dtypes)


@pytest.mark.parametrize("channels,lanes", [
    (16, 2),       # 16 points a warp
    (64, 8),       # every config: the P = 4 points of a (slice, query)
    (128, 16),
    (256, 32),     # one point a warp
])
def test_onehot_lanes_per_point(channels, lanes):
    assert onehot_lanes_per_point(channels, torch.bfloat16) == lanes
    assert onehot_lanes_per_point(channels, torch.bfloat16) \
        == sample_lanes_per_point(channels, torch.bfloat16)


@pytest.mark.parametrize("channels,dtype,match", [
    (6, torch.bfloat16, "multiple of 16"),
    (260, torch.bfloat16, "multiple of 16"),
    (264, torch.bfloat16, "more than the 32 lanes"),
    (64, torch.float32, "the table must be bf16"),
    (64, torch.float16, "the table must be bf16"),
])
def test_onehot_kernels_refuse(channels, dtype, match):
    with pytest.raises(ValueError, match=match):
        onehot_lanes_per_point(channels, dtype)


@pytest.mark.parametrize("levels,ok", [(1, True), (8, True), (9, False),
                                       (0, False)])
def test_onehot_fused_level_count(levels, ok):
    """One launch takes 1 to 8 levels (the kernel's template parameter)."""
    s, q, p, n, c, h, w = 2, 3, 4, 2, 8, 3, 3
    rng = np.random.RandomState(levels)
    tables = [torch.from_numpy(rng.randn(s, n * h, w * c).astype(np.float32))
              .to(torch.bfloat16) for _ in range(levels)]
    loc = torch.from_numpy(rng.rand(s, q, p, 3).astype(np.float32))
    sw = torch.from_numpy(rng.rand(s, q, p, max(levels, 1))
                          .astype(np.float32))
    out = torch.zeros((s * q * p, c))
    args = (tables, [(h, w)] * levels, list(range(levels)), loc, sw, out, n,
            c)
    if ok:
        assert msmv_onehot.onehot_sample_levels(*args) is out
        assert bool(out.any())
    else:
        with pytest.raises(ValueError, match="takes 1 to 8 levels"):
            msmv_onehot.onehot_sample_levels(*args)


@pytest.mark.parametrize("p,padded", [(32, 32), (60, 64), (7, 32), (16, 32),
                                      (1, 32), (65, 128), (120, 128)])
def test_mixing_padded_points(p, padded):
    """The tensor-core kernels' widths: 32, 64 or 128 in-points."""
    assert padded_points(p) == padded
    assert padded in (32, 64, 128) and p <= padded


def test_mixing_padded_points_refuses_no_points():
    with pytest.raises(ValueError, match="in-points"):
        padded_points(0)


def test_mixing_padded_points_refuses_more_than_the_widest_kernel():
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        padded_points(129)


@pytest.mark.parametrize("dtype,p,c,o,route", [
    (torch.bfloat16, 32, 64, 128, "mma"),     # r50
    (torch.bfloat16, 60, 64, 128, "mma"),     # vov99: padded to 64
    (torch.bfloat16, 2, 64, 128, "mma"),
    (torch.bfloat16, 7, 64, 128, "fma"),      # odd P: 14-byte rows of s
    (torch.bfloat16, 66, 64, 128, "mma"),     # padded to 128
    (torch.bfloat16, 32, 16, 32, "fma"),      # not the decoder's widths
    (torch.float32, 32, 64, 128, "tf32"),     # fp32 in 3xTF32
    (torch.float32, 60, 64, 128, "tf32"),
    (torch.bfloat16, 120, 64, 128, "mma"),    # EVA02: 8 points x 15 frames
    (torch.bfloat16, 130, 64, 128, "fma"),    # more than 128 padded points
    (torch.float32, 120, 64, 128, "tf32"),
    (torch.float32, 7, 64, 128, "tf32"),      # any P: 4-byte copies of s
    (torch.float32, 130, 64, 128, "fma"),
    (torch.float32, 32, 16, 32, "fma"),
])
def test_mixing_route(dtype, p, c, o, route):
    assert mixing_route(dtype, p, c, o) == route


def test_mixing_route_info_refuses_the_fma_route():
    """``route_info`` describes the tensor-core routes only; it raises
    before it builds anything."""
    with pytest.raises(ValueError, match="no tensor-core route"):
        mixing.route_info(torch.float32, 130)
    with pytest.raises(ValueError, match="no tensor-core route"):
        mixing.route_info(torch.bfloat16, 7)


@pytest.mark.parametrize("mangled,name", [
    # nvcc names an anonymous namespace after the source and a hash that
    # may end in digits; the kernel's own name may hold digits
    ("_ZN41_INTERNAL_2c8b1e9e_9_mixing_cu_99a6059918mixing_tf32_kernel"
     "ILi128ELb1EEEvPKfS2_S2_Pfiif", "mixing_tf32_kernel<128, true>"),
    ("_ZN41_INTERNAL_2c8b1e9e_9_mixing_cu_99a6059917mixing_mma_kernel"
     "ILi64ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_iif",
     "mixing_mma_kernel<64, false>"),
    ("_ZN41_INTERNAL_2c8b1e9e_9_mixing_cu_99a6059913mixing_kernel"
     "I13__nv_bfloat16Lb1EEEvPKT_S4_S4_PS2_iiif",
     "mixing_kernel<__nv_bfloat16, true>"),
    ("_ZN41_INTERNAL_2c8b1e9e_17eva_attention_cu_5a1b2c3d25eva_attention_"
     "dkdv_kernelEv", "eva_attention_dkdv_kernel"),
])
def test_ptxas_report_names_each_kernel(mangled, name):
    """chip_smoke.py's ptxas report names each instantiation as the routes'
    lines look it up (``mixing_routes``)."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    text = (f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'\nptxas info    : Used 109 registers, 0 bytes smem")
    (row,) = chip_smoke.ptxas_report(text)
    assert row["kernel"] == name and row["regs"] == 109


def test_mixing_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        mixing_route(torch.float16, 32, 64, 128)


def _masked_ln(t, rows, stats):
    """``mixing._ln2d`` with the statistics over the first ``rows`` rows of
    ``t [.., R, C]`` only."""
    n = rows * t.shape[-1]
    live = t[..., :rows, :]
    mu = live.sum(dim=(-2, -1), keepdim=True) / n
    if stats == "twopass":
        d = live - mu
        var = (d * d).sum(dim=(-2, -1), keepdim=True) / n
    else:
        sq = (live * live).sum(dim=(-2, -1), keepdim=True) / n
        var = (sq - mu * mu).clamp(min=0.0)
    return (t - mu) * torch.rsqrt(var + mixing.EPS)


def _padded_chain(x, m, s, stats, mask=True):
    """The tensor-core kernel's scheme in plain PyTorch: x gets padding rows
    (arbitrary values: their products are never used), s gets zero columns,
    LN1 runs over the P real rows and h1's padding rows are zeroed. With
    ``mask=False`` the padding rows are zeros and LN1 runs over all PP."""
    p = x.shape[-2]
    pp = padded_points(p)
    fill = 3.0 if mask else 0.0
    xp = torch.full(x.shape[:-2] + (pp, x.shape[-1]), fill, dtype=x.dtype)
    xp[..., :p, :] = x
    sp = torch.zeros(s.shape[:-1] + (pp,), dtype=s.dtype)
    sp[..., :p] = s
    h1 = torch.matmul(xp.float(), m.float())
    h1 = torch.relu(_masked_ln(h1, p if mask else pp, stats))
    h1[..., p:, :] = 0.0
    h1 = h1.to(x.dtype)
    h2 = torch.matmul(sp.float(), h1.float())
    return torch.relu(_masked_ln(h2, h2.shape[-2], stats)).to(x.dtype)


def _operands(seed, p, c=16, o=32, items=5):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(items, 2, p, c).astype(np.float32))
    m = torch.from_numpy((rng.randn(items, 2, c, c) / np.sqrt(c))
                         .astype(np.float32))
    s = torch.from_numpy((rng.randn(items, 2, o, p) / np.sqrt(p))
                         .astype(np.float32))
    return x, m, s


@pytest.mark.parametrize("p", [32, 60, 7, 120])
@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_padded_chain_equals_plain(p, stats):
    x, m, s = _operands(p, p)
    want = mixing_core_plain(x, m, s, stats=stats)
    got = _padded_chain(x, m, s, stats)
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_padding_inside_the_ln_would_change_the_result(stats):
    """Why the mask is there: with the padded rows inside LN1's statistics
    (n = PP * C, and in the two-pass variance a term mu^2 per padded zero)
    the output moves far beyond the tolerance."""
    x, m, s = _operands(11, 60)
    want = mixing_core_plain(x, m, s, stats=stats)
    got = _padded_chain(x, m, s, stats, mask=False)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) > 1e-3 * scale


def test_padded_chain_bf16_within_the_card_tolerance():
    """bf16 operands: the padded replay against the plain version within the
    tolerance the smoke run holds the kernel to (2^-7 of each value plus
    2^-8 of the output scale)."""
    x, m, s = (t.to(torch.bfloat16) for t in _operands(5, 60))
    want = mixing_core_plain(x, m, s).float()
    got = _padded_chain(x, m, s, "twopass").float()
    scale = max(1.0, float(want.abs().max()))
    assert bool(((got - want).abs()
                 <= 2.0 ** -7 * want.abs() + 2.0 ** -8 * scale).all())


@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_padded_chain_bf16_at_eva02_points(stats):
    """The same at EVA02's P = 120 (8 points x 15 frames), padded to 128,
    as the bf16 tensor-core kernel takes it since its range was widened
    to 128 padded in-points, for both statistics."""
    rtol, atol = mixing.MIXING_TOL["bfloat16"]
    x, m, s = (t.to(torch.bfloat16) for t in _operands(6, 120))
    want = mixing_core_plain(x, m, s, stats=stats).float()
    got = _padded_chain(x, m, s, stats).float()
    scale = max(1.0, float(want.abs().max()))
    assert bool(((got - want).abs() <= rtol * want.abs() + atol * scale)
                .all())


# ------------------------------------------- the attention kernel's order --

KEYS = 64               # keys a tile of csrc/eva_attention.cu
STEP = 32               # keys a step of its online softmax


def _tf32_rna(x):
    """fp32 -> TF32 by bit mask, to nearest with ties away from zero (the
    kernel's integer add and mask, as cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x):
    """What the tensor cores read of an fp32 register: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mma(acc, a, b):
    """One m16n8k8 product into the fp32 accumulator, modelled as its 8
    TF32 x TF32 products summed exactly and added with one rounding toward
    zero (the tensor cores truncate: with one running output accumulator
    this model lands 2.8e-5 of the scale at N = 4000, the card 3.0e-5)."""
    exact = acc.double() + _tf32_read(a).double() @ _tf32_read(b).double()
    out = exact.float()
    return torch.where(out.double().abs() > exact.abs(),
                       torch.nextafter(out, torch.zeros_like(out)), out)


def _products(acc, a, b, groups, products, small=None, a_hi=_tf32_rna,
              b_hi=_tf32_rna):
    """acc += a @ b over the contraction ``groups`` (8 indices each, one
    k-step): three TF32 products a k-step (lo*hi, hi*lo, hi*hi) or one. With
    ``small`` the two small products go into that accumulator instead;
    returns ``(acc, small)`` then. ``a_hi`` / ``b_hi``: each operand's hi
    (rounded to nearest as the kernels split registers, or
    :func:`_tf32_read` where a raw fp32 tile is the hi operand); lo is the
    rest, read by the tensor cores as its top 19 bits."""
    for idx in groups:
        ak, bk = a[:, idx], b[idx, :]
        ah, bh = a_hi(ak), b_hi(bk)
        if products == 3:
            if small is None:
                acc = _mma(acc, ak - ah, bh)
                acc = _mma(acc, ah, bk - bh)
            else:
                small = _mma(small, ak - ah, bh)
                small = _mma(small, ah, bk - bh)
        acc = _mma(acc, ah, bh)
    return acc if small is None else (acc, small)


def _dim_groups(hd=64):
    """The head dims of each k-step of S = q k^T: k-step 2p takes dims
    16p + 4t and 16p + 4t + 1 (columns t and t + 4), k-step 2p + 1 dims
    16p + 4t + 2 and + 3."""
    groups = []
    for p in range(hd // 16):
        for off in (0, 2):
            groups.append([16 * p + 4 * t + off for t in range(4)]
                          + [16 * p + 4 * t + off + 1 for t in range(4)])
    return groups


def _key_groups(j0, keys):
    """The keys of each k-step of O += P V, in the fragment's order: column
    t is key 8j + 2t, column t + 4 key 8j + 2t + 1 (the permuted V rows)."""
    return [[j0 + 8 * j + 2 * t for t in range(4)]
            + [j0 + 8 * j + 2 * t + 1 for t in range(4)]
            for j in range(keys // 8)]


def _replay_attention(q, k, v, products=3):
    """csrc/eva_attention.cu's arithmetic for one head, ``[N, 64]`` fp32:
    64-key tiles (the last zero-filled past N), each taken as two steps of
    32 keys: S with hi*hi and the small products in two accumulators, added
    once, scaled by 1/8, the keys past N at -inf; the online softmax in
    fp32; the step's P V in a fresh accumulator, added as ``o * corr + pv``
    in one rounding (fmaf); O divided by the row sum at the end."""
    n, hd = q.shape
    tiles = -(-n // KEYS)
    kp = torch.zeros(tiles * KEYS, hd)
    vp = torch.zeros(tiles * KEYS, hd)
    kp[:n], vp[:n] = k, v
    m = torch.full((n, 1), -float("inf"))
    l = torch.zeros(n, 1)
    o = torch.zeros(n, hd)
    for j0 in range(0, tiles * KEYS, STEP):
        zeros = torch.zeros(n, STEP)
        kt = kp[j0:j0 + STEP].T
        if products == 3:
            big, small = _products(zeros, q, kt, _dim_groups(hd), 3,
                                   small=zeros.clone())
            s = big + small
        else:
            s = _products(zeros, q, kt, _dim_groups(hd), 1)
        s = s * 0.125
        s[:, max(n - j0, 0):] = -float("inf")
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=1, keepdim=True)
        pv = _products(torch.zeros(n, hd), p, vp[j0:j0 + STEP],
                       [[i - j0 for i in g] for g in _key_groups(j0, STEP)],
                       products)
        o = (o.double() * corr.double() + pv.double()).float()
        m = m_new
    return o / l


def _attention_operands(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, 1, 64).astype(np.float32) for _ in range(3)]


def _replay_error(n, products, reference):
    q, k, v = _attention_operands(n, n)
    if reference == "plain":
        from sparsebev_tpu_torch.ops.eva_attention import eva_attention_plain
        want = eva_attention_plain(*map(torch.from_numpy, (q, k, v)))
        want = want.numpy()
    else:
        import jax
        import jax.numpy as jnp
        want = np.asarray(jax.nn.dot_product_attention(
            *map(jnp.asarray, (q, k, v))))
    got = _replay_attention(*(torch.from_numpy(a[0, :, 0]) for a in (q, k, v)),
                            products=products)
    return (float(np.abs(got.numpy() - want[0, :, 0]).max())
            / float(np.abs(want).max()))


def test_replay_groups_cover_each_index_once():
    assert sorted(sum(_dim_groups(), [])) == list(range(64))
    assert sorted(sum(_key_groups(64, KEYS), [])) == list(range(64, 128))


@pytest.mark.parametrize("reference", ["plain", "jax"])
@pytest.mark.parametrize("n", [200, 300])
def test_attention_3xtf32_replay_within_the_card_tolerance(n, reference):
    """Three TF32 products a k-step: fp32-level attention, within the
    tolerance the card holds the kernel to, of the plain version and of
    ``jax.nn.dot_product_attention`` (N = 200 and 300: a ragged last
    tile)."""
    assert _replay_error(n, 3, reference) <= ATTENTION_TOL


@pytest.mark.parametrize("n", [200, 300])
def test_attention_1xtf32_replay_misses_the_tolerance(n):
    """One TF32 product a k-step (plain TF32) lands outside the same
    tolerance: the test tells the two routes apart."""
    assert _replay_error(n, 1, "plain") > 10 * ATTENTION_TOL


# ----------------------------------- the attention backward kernels' order --

STREAM = 32             # rows of a tile the backward kernels stream
OWN = 64                # own rows of a consumer warpgroup


def _dim_steps(depth):
    """The contraction indices of each wgmma k-step: 8 consecutive ones
    (the head dim of a score product; the streamed rows of a
    sequence-summed one, whose permuted order inside a k-step changes no
    product sum)."""
    return [list(range(8 * kk, 8 * kk + 8)) for kk in range(depth // 8)]


def _score(a, b, products):
    """A score product of the backward kernels, ``a [rows, 64] @ b [cols,
    64]^T``: each operand's raw fp32 values are its hi (the tensor cores
    read their top 19 bits), lo = x - trunc(x); hi*hi and the two small
    products in two accumulators, added once."""
    zeros = torch.zeros(a.shape[0], b.shape[0])
    steps = _dim_steps(a.shape[1])
    if products == 3:
        big, small = _products(zeros, a, b.T, steps, 3, small=zeros.clone(),
                               a_hi=_tf32_read, b_hi=_tf32_read)
        return big + small
    return _products(zeros, a, b.T, steps, 1, a_hi=_tf32_read,
                     b_hi=_tf32_read)


def _step_sum(p, b, products):
    """A 32-row step of a sequence-summed product, ``p [rows, 32] @ b [32,
    64]``, in a fresh accumulator: p from registers (split to nearest), b's
    transposed tile raw as hi."""
    return _products(torch.zeros(p.shape[0], b.shape[1]), p, b,
                     _dim_steps(p.shape[1]), products, b_hi=_tf32_read)


def _replay_attention_backward(q, k, v, o, lse, dout, products=3):
    """csrc/eva_attention.cu's backward for one head, ``[N, 64]`` fp32,
    ``lse`` ``[N]``: D = rowsum(dO o); the dK / dV kernel over 32-query
    tiles (queries past N at lse = +inf, D = 0): S^T = k q^T,
    P^T = exp(S^T / 8 - lse), dP^T = v dO^T, dS^T = P^T (dP^T - D),
    dv += P^T dO, dk += dS^T q; the dQ kernel over 32-key tiles (keys past
    N at P = 0): S = q k^T, P, dP = dO v^T, dS, dq += dS k; each tile's sum
    added to the running one in fp32; dq and dk times 1/8 at the end."""
    n, hd = q.shape
    rows = -(-n // OWN) * OWN
    pad = (lambda x, fill=0.0: torch.cat(
        [x, torch.full((rows - n,) + x.shape[1:], fill)]))
    qp, kp, vp, gp = (pad(x) for x in (q, k, v, dout))
    delta = (dout * o).sum(-1)
    lse_p, delta_p = pad(lse, float("inf")), pad(delta)
    dk = torch.zeros(rows, hd)
    dv = torch.zeros(rows, hd)
    dq = torch.zeros(rows, hd)
    for i0 in range(0, rows, STREAM):
        qs, gs = qp[i0:i0 + STREAM], gp[i0:i0 + STREAM]
        pt = torch.exp(_score(kp, qs, products) * 0.125
                       - lse_p[i0:i0 + STREAM])
        dst = pt * (_score(vp, gs, products) - delta_p[i0:i0 + STREAM])
        dv = dv + _step_sum(pt, gs, products)
        dk = dk + _step_sum(dst, qs, products)
    for j0 in range(0, rows, STREAM):
        ks, vs = kp[j0:j0 + STREAM], vp[j0:j0 + STREAM]
        p = torch.exp(_score(qp, ks, products) * 0.125 - lse_p[:, None])
        p[:, max(n - j0, 0):] = 0.0
        ds = p * (_score(gp, vs, products) - delta_p[:, None])
        dq = dq + _step_sum(ds, ks, products)
    return dq[:n] * 0.125, dk[:n] * 0.125, dv[:n]


def _backward_replay_errors(n, products, reference):
    from sparsebev_tpu_torch.ops.eva_attention import (
        eva_attention_backward_plain, eva_attention_lse_plain,
        eva_attention_plain)
    rng = np.random.RandomState(n + 1)
    q, k, v, g = (torch.from_numpy(rng.randn(1, n, 1, 64).astype(np.float32))
                  for _ in range(4))
    out = eva_attention_plain(q, k, v)
    lse = eva_attention_lse_plain(q, k)
    if reference == "plain":
        want = eva_attention_backward_plain(q, k, v, out, lse, g)
        want = [w.numpy()[0, :, 0] for w in want]
    else:
        import jax
        import jax.numpy as jnp
        _, vjp = jax.vjp(jax.nn.dot_product_attention,
                         *(jnp.asarray(x.numpy()) for x in (q, k, v)))
        want = [np.asarray(w)[0, :, 0] for w in vjp(jnp.asarray(g.numpy()))]
    got = _replay_attention_backward(
        *(x[0, :, 0] for x in (q, k, v, out)), lse[0, 0], g[0, :, 0],
        products=products)
    return [float(np.abs(a.numpy() - b).max()) / float(np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("reference", ["plain", "jax"])
@pytest.mark.parametrize("n", [200, 300])
def test_attention_backward_3xtf32_replay_within_the_card_tolerance(
        n, reference):
    """The backward kernels' order in 3xTF32 (wgmma k-steps, the raw
    values as truncated hi operands, 32-row steps in fresh accumulators):
    dq, dk and dv each within the tolerance the card holds the kernel to,
    of the plain version and of ``jax.vjp`` of
    ``jax.nn.dot_product_attention`` (a ragged last tile at both N)."""
    from sparsebev_tpu_torch.ops.eva_attention import ATTENTION_BWD_TOL
    assert max(_backward_replay_errors(n, 3, reference)) <= ATTENTION_BWD_TOL


def test_attention_backward_1xtf32_replay_misses_the_tolerance():
    """One TF32 product a k-step lands outside the same tolerance."""
    from sparsebev_tpu_torch.ops.eva_attention import ATTENTION_BWD_TOL
    assert min(_backward_replay_errors(200, 1, "plain")) > \
        10 * ATTENTION_BWD_TOL


# ---------------------------------------- the mixing kernel's 3xTF32 order --


def _replay_mixing(x, m, s, stats, products=3):
    """csrc/mixing.cu's fp32 route, ``mixing_tf32_kernel``, item by item:
    x @ m in 8-deep k-steps of three TF32 products (lo*hi, hi*lo, hi*hi,
    each operand split to nearest) into one truncating accumulator, or one
    product; LN1 over the P real rows; h1 in fp32 with its padding rows
    zero; s @ h1 over the depth padded to 32, 64 or 128 (s's padding
    columns zero) in the same order; LN2."""
    p, c = x.shape[-2:]
    o = s.shape[-2]
    pp = padded_points(p)
    xs, ms, ss = (t.reshape((-1,) + t.shape[-2:]) for t in (x, m, s))
    out = torch.empty(xs.shape[0], o, c)
    for b in range(xs.shape[0]):
        h1 = _products(torch.zeros(p, c), xs[b], ms[b], _dim_steps(c),
                       products)
        h1 = torch.cat([torch.relu(mixing._ln2d(h1, stats)),
                        torch.zeros(pp - p, c)])
        sp = torch.cat([ss[b], torch.zeros(o, pp - p)], dim=1)
        h2 = _products(torch.zeros(o, c), sp, h1, _dim_steps(pp), products)
        out[b] = torch.relu(mixing._ln2d(h2, stats))
    return out.reshape(s.shape[:-2] + (o, c))


def _mixing_replay_error(p, stats, products, reference):
    """max |replay - reference| over the output scale, BQ = 2, G = 4,
    C = 64, O = 128; the reference the plain version or, in JAX,
    ``_mixing_core_xla`` (two-pass) or the batched Pallas kernel in
    interpret mode (one-pass)."""
    x, m, s = (t.reshape((2, 4) + t.shape[2:])
               for t in _operands(p + 1, p, c=64, o=128, items=4))
    if reference == "plain":
        want = mixing_core_plain(x, m, s, stats=stats).numpy()
    else:
        import jax
        import jax.numpy as jnp
        from sparsebev_tpu.ops import mixing_pallas as jmix
        args = [jnp.asarray(t.numpy()) for t in (x, m, s)]
        if stats == "twopass":
            want = jax.jit(jmix._mixing_core_xla)(*args)
        else:
            want = jmix.mixing_core_tpu_batched(*args, bq_blk=2,
                                                interpret=True)
        want = np.asarray(want)
    got = _replay_mixing(x, m, s, stats, products).numpy()
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want)
                                                            .max()))


@pytest.mark.parametrize("reference", ["plain", "jax"])
@pytest.mark.parametrize("stats", ["twopass", "onepass"])
@pytest.mark.parametrize("p", [32, 120])
def test_mixing_3xtf32_replay_within_the_card_tolerance(p, stats, reference):
    """Three TF32 products a k-step, one truncating accumulator: within
    ``MIXING_TOL["float32"]`` of the plain version and of JAX at r50's
    P = 32 and EVA02's P = 120 (padded to 128), for both statistics."""
    rtol, atol = mixing.MIXING_TOL["float32"]
    assert rtol == 0.0
    assert _mixing_replay_error(p, stats, 3, reference) <= atol


@pytest.mark.parametrize("p", [32, 120])
def test_mixing_1xtf32_replay_misses_the_tolerance(p):
    """One TF32 product a k-step (plain TF32) lands outside the same
    tolerance: the test tells the two orders apart."""
    atol = mixing.MIXING_TOL["float32"][1]
    assert _mixing_replay_error(p, "twopass", 1, "plain") > 10 * atol


# ------------------------------- the backward kernels' shared-memory tiles --
# csrc/eva_attention.cu's operand tiles, K-major with the 128-byte swizzle:
# halves of 32 fp32 values a row (an own tile: 64 rows x 64 values, two
# halves; a streamed tile: 32 rows x 64 values, two halves; a transposed
# tile: 64 head-dim rows x 32 streamed rows, one half), each row 128 bytes
# whose 16-byte chunk c sits at c ^ (row % 8). The maps below restate the
# source's sw_off, kstep / tile_desc (leading offset 1, 8-row groups 1024
# bytes apart), sum3's head-dim halves, the TMA boxes, build_t's parts
# and split_rows' order.


def _swizzle(byte):
    """The 128-byte swizzle on a shared-memory byte address (a tile at a
    1024-byte boundary): bits 4-6 ^= bits 7-9."""
    return byte ^ (((byte >> 7) & 7) << 4)


def _sw_off(rows, r, k):
    """The source's sw_off<rows>: float offset of value k of row r."""
    return (k >> 5) * (rows * 32) + r * 32 + \
        ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3)


def _tma_byte(rows, r, c):
    """Where TMA puts value c of row r of a tile (box c // 32 of rows x 32
    values, rows of 128 bytes, swizzled)."""
    return _swizzle((c // 32) * rows * 128 + r * 128 + (c % 32) * 4)


def _desc_byte(rows, kk, r, k, first_row=0):
    """Where wgmma reads element (row r, column k) of k-step kk through the
    descriptor of a tile of ``rows`` rows started at row ``first_row``:
    start = (kk // 4) * rows * 128 + (kk % 4) * 32 (+ first_row * 128),
    then the canonical K-major layout ((8, n), 2) : ((128 B, SBO = 1024 B),
    16 B) and the swizzle."""
    start = (kk // 4) * rows * 128 + (kk % 4) * 32 + first_row * 128
    return _swizzle(start + (r % 8) * 128 + (r // 8) * 1024 + (k // 4) * 16
                    + (k % 4) * 4)


def _kpos(s):
    """K position of streamed row s in a transposed tile."""
    return (s & ~7) | ((s & 1) << 2) | ((s >> 1) & 3)


def _build_t_parts():
    """build_t's 128 parts: (streamed rows, first head dim, first K
    position of the transposed chunks)."""
    out = []
    for f in range(128):
        e = (f & 3) | ((f >> 1) & 12)
        g8 = ((f >> 2) & 1) | ((f >> 4) & 2)
        par = (f >> 6) & 1
        out.append(([8 * g8 + 2 * u + par for u in range(4)], 4 * e,
                    8 * g8 + 4 * par))
    return out


@pytest.mark.parametrize("rows", [OWN, STREAM])
@pytest.mark.parametrize("half", [0, 1])
def test_thread_tiles_match_tma_placement(rows, half):
    """The threads' store map (sw_off) puts every value where TMA puts it,
    once: a lo tile lines up with its raw tile element by element."""
    cols = range(32 * half, 32 * half + 32)
    offs = {(r, c): _sw_off(rows, r, c) for r in range(rows) for c in cols}
    assert all(4 * o == _tma_byte(rows, r, c) for (r, c), o in offs.items())
    assert sorted(offs.values()) == list(
        range(rows * 32 * half, rows * 32 * (half + 1)))


@pytest.mark.parametrize("rows", [OWN, STREAM])
@pytest.mark.parametrize("kk", range(8))
def test_descriptor_reads_what_the_threads_store(rows, kk):
    """k-step kk of a descriptor reads, at (row r, column k), the value the
    threads (and TMA) stored as value 8kk + k of row r."""
    for r in range(rows):
        for k in range(8):
            assert _desc_byte(rows, kk, r, k) == 4 * _sw_off(rows, r,
                                                            8 * kk + k)


def test_transpose_build_covers_each_element_once():
    """build_t reads each raw element of a streamed tile once and writes it
    once to its lo tile (the same offset) and once to the transposed tiles,
    at (row d, K position of its streamed row), where sum3's descriptors
    read it (head dims 32m .. 32m + 31 from row 32m on)."""
    raw, trans = [], []
    for rows, d0, kp in _build_t_parts():
        for u, s in enumerate(rows):
            assert _kpos(s) == kp + u
            for j in range(4):
                raw.append(_sw_off(STREAM, s, d0 + j))
                trans.append((_sw_off(OWN, d0 + j, kp + u), (s, d0 + j)))
    assert sorted(raw) == list(range(STREAM * 64))
    assert sorted(o for o, _ in trans) == list(range(OWN * STREAM))
    for off, (s, d) in trans:
        kk, k = divmod(_kpos(s), 8)
        m, r = divmod(d, 32)
        assert _desc_byte(OWN, kk, r, k, first_row=32 * m) == 4 * off


@pytest.mark.parametrize("kk", range(4))
def test_accumulator_to_a_fragment_order(kk):
    """split_rows: accumulator register 4kk + c of lane (g, t) holds column
    8kk + 2t + (c & 1); it goes to A register (0, 2, 1, 3)[c], whose K
    column is t (registers 0, 1) or t + 4 (2, 3); that K column of the
    transposed B tile holds the same streamed row."""
    a_reg = (0, 2, 1, 3)
    for t in range(4):
        cols = {}
        for c in range(4):
            seq = 8 * kk + 2 * t + (c & 1)
            k_col = t if a_reg[c] < 2 else t + 4
            assert _kpos(seq) == 8 * kk + k_col
            cols.setdefault(k_col, set()).add(c >> 1)   # rows g, g + 8
        assert cols == {t: {0, 1}, t + 4: {0, 1}}


def test_own_fragments_cover_the_tile():
    """load_frags: the raw A fragments of the 4 warps x 32 lanes cover each
    (row, head dim) of an own tile once, k-step kk holding dims
    8kk .. 8kk + 7 at A columns t and t + 4."""
    seen = set()
    for warp in range(4):
        for lane in range(32):
            r, t = 16 * warp + (lane >> 2), lane & 3
            for kk in range(8):
                for rr, col in ((r, t), (r + 8, t), (r, t + 4),
                                (r + 8, t + 4)):
                    seen.add((rr, 8 * kk + col))
    assert seen == {(r, d) for r in range(OWN) for d in range(64)}
