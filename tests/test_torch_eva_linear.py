"""The EVA02 trunk's product op on the CPU (``ops/eva_linear.py``): the
plain path is ``F.linear`` bit for bit, the wrapper refuses what the kernel
does not take, ``EvaLinearFunction``'s gradients are ``F.linear``'s, the
trunk routes its seven products a block through the op, and a replay of
the kernel's arithmetic (``csrc/eva_linear.cu``: 3xTF32 with truncating
wgmma accumulators promoted every 16 k-steps, over its 128 x 128 tiles and
32-deep K-slices) lands within ``LINEAR_TOL`` of the fp64 product, where
one TF32 product a k-step or one unpromoted accumulator lands outside."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparsebev_tpu_torch.models import eva02 as teva
from sparsebev_tpu_torch.ops import eva_linear as el
from sparsebev_tpu_torch.ops.eva_linear import (LINEAR_TOL,
                                                EvaLinearFunction,
                                                eva_linear)
from test_torch_kernel_layouts import _mma, _tf32_read

torch.set_num_threads(1)


def _operands(m, n, k, bias=True, seed=0):
    """x from N(0, 1) (the trunk's products read LayerNorm outputs), W and
    b uniform within 1/sqrt(K), as nn.Linear draws them."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32))
    bound = 1 / math.sqrt(k)
    w = torch.from_numpy(rng.uniform(-bound, bound, (n, k)).astype(
        np.float32))
    b = (torch.from_numpy(rng.uniform(-bound, bound, n).astype(np.float32))
         if bias else None)
    return x, w, b


# ----------------------------------------------------------- the wrapper --

@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("lead", [(7,), (2, 5), (2, 3, 4)])
def test_cpu_path_is_f_linear_bit_for_bit(bias, lead):
    x, w, b = _operands(math.prod(lead), 12, 20, bias)
    x = x.view(*lead, 20)
    got = eva_linear(x, w, b)
    assert got.shape == (*lead, 12)
    assert torch.equal(got, F.linear(x, w, b))


def _refused():
    x, w, b = _operands(6, 4, 8)
    return {
        "bf16 x": ((x.bfloat16(), w, b), "fp32 operands only"),
        "fp64 weight": ((x, w.double(), b), "fp32 operands only"),
        "bf16 bias": ((x, w, b.bfloat16()), "fp32 operands only"),
        "non-contiguous x": ((x.t().contiguous().t(), w, b),
                             "must be contiguous"),
        "mismatched K": ((x[:, :6].contiguous(), w, b), "must share K"),
        "weight not 2-d": ((x, w[None], b), "must share K"),
        "bias of another width": ((x, w, b[:3]), "bias must be"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_wrapper_refuses(case):
    args, match = _refused()[case]
    calls = eva_linear.calls
    with pytest.raises(ValueError, match=match):
        eva_linear(*args)
    assert eva_linear.calls == calls


def test_cuda_branch_refuses_other_devices():
    x, w, b = _operands(4, 2, 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        el._eva_linear_cuda(x, w, b)


def test_counts_calls_and_launches_no_kernel_on_the_cpu():
    x, w, b = _operands(4, 2, 8)
    calls, launches = eva_linear.calls, eva_linear.launches
    eva_linear(x, w, b)
    eva_linear(x, w)
    assert eva_linear.calls - calls == 2
    assert eva_linear.launches == launches


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("lead", [(9,), (3, 5), (2, 3, 4)])
def test_function_gradients_equal_f_linears(bias, lead):
    """``EvaLinearFunction`` on the CPU: the output and the gradients of x,
    W and b equal autograd of ``F.linear`` bit for bit."""
    x, w, b = _operands(math.prod(lead), 6, 10, bias, seed=3)
    x = x.view(*lead, 10)
    dy = torch.from_numpy(np.random.RandomState(4).randn(
        *lead, 6).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, b) if t is not None]

    def run(fn):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(ts[0], ts[1], ts[2] if bias else None)
        grads = torch.autograd.grad(out, ts, dy)
        return out.detach(), grads

    want, want_grads = run(F.linear)
    got, got_grads = run(EvaLinearFunction.apply)
    assert torch.equal(got, want)
    for g, r in zip(got_grads, want_grads):
        assert torch.equal(g, r)


def test_function_skips_the_gradients_not_asked_for():
    x, w, b = _operands(5, 3, 4, seed=5)
    w.requires_grad_()
    out = EvaLinearFunction.apply(x, w, b)
    (gw,) = torch.autograd.grad(out.sum(), [w])
    assert torch.equal(gw, torch.ones(5, 3).t().mm(x))


# --------------------------------------------------------------- the trunk --

TRUNK = dict(img_size=256, real_img_size=(64, 160), patch_size=16,
             embed_dim=64, depth=3, num_heads=4, window_size=4,
             window_block_indexes=(0, 1), fpn_out_channels=32,
             fpn_scale_factors=(4.0, 2.0, 1.0, 0.5), fpn_top_block=True,
             pretrain_img_size=32)


@pytest.mark.parametrize("remat", [False, True])
def test_trunk_counts_seven_products_a_block(remat):
    """A small EVA02 trunk (embed 64, 2 windowed and 1 global block) calls
    the op seven times a block call (q, k, v, proj, w1, w2, w3), the
    remat's recompute once more a block; the CPU launches no kernel."""
    torch.manual_seed(0)
    model = teva.EVA02(**TRUNK, use_act_checkpoint=remat)
    img = torch.randn(6, 3, 64, 160)
    calls, launches = eva_linear.calls, eva_linear.launches
    if remat:
        sum(f.sum() for f in model(img)).backward()
    else:
        with torch.no_grad():
            model(img)
    depth = TRUNK["depth"]
    assert eva_linear.calls - calls == 7 * depth * (2 if remat else 1)
    assert eva_linear.launches == launches


def test_trunk_products_match_f_linear():
    """The blocks' outputs are unchanged by the routing: the trunk's
    SwiGLU and attention on the CPU against the same modules with every
    product taken by ``F.linear``."""
    torch.manual_seed(1)
    blk = teva.EVA02(**TRUNK).net.blocks[2]
    x = torch.randn(6, 4, 10, 64)
    cos, sin = (torch.randn(40, 16) for _ in range(2))
    with torch.no_grad():
        got = (blk.mlp(x), blk.attn(x, cos, sin))
        saved = teva.eva_linear
        teva.eva_linear = F.linear
        try:
            want = (blk.mlp(x), blk.attn(x, cos, sin))
        finally:
            teva.eva_linear = saved
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------ the kernel's arithmetic --

TILE = 128          # output rows and columns a tile
SLICE = 32          # K values a slice
PROMOTE = 16        # k-steps a promotion of the wgmma accumulator


def _replay(x, w, b, products=3, promote=PROMOTE):
    """csrc/eva_linear.cu's arithmetic for ``x [M, K] @ w[N, K]^T + b``:
    W's rows padded with zeros to whole 128-column tiles and K to whole
    32-deep slices (as TMA and the zero-filled cp.async pieces leave them);
    per 8-deep k-step the raw fp32 operands are their own hi (the tensor
    cores read the top 19 bits) and lo = v - trunc(v); three products
    lo*hi, hi*lo, hi*hi (or hi*hi alone) into one truncating accumulator
    (``_mma``), added into the fp32 sum every ``promote`` k-steps and at
    the end (``promote`` 0: one accumulator over all of K); then the bias;
    the padded columns cut off as the kernel's masked stores leave them."""
    m, k = x.shape
    n = w.shape[0]
    kp = -(-k // SLICE) * SLICE
    np_ = -(-n // TILE) * TILE
    xp = torch.zeros(m, kp)
    xp[:, :k] = x
    wp = torch.zeros(kp, np_)
    wp[:k, :n] = w.t()
    acc = torch.zeros(m, np_)
    total = torch.zeros(m, np_)
    for s in range(kp // 8):
        if promote and s and s % promote == 0:
            total, acc = total + acc, torch.zeros(m, np_)
        a, bb = xp[:, 8 * s:8 * s + 8], wp[8 * s:8 * s + 8]
        ah, bh = _tf32_read(a), _tf32_read(bb)
        if products == 3:
            acc = _mma(acc, a - ah, bh)
            acc = _mma(acc, ah, bb - bh)
        acc = _mma(acc, ah, bh)
    out = (total + acc)[:, :n]
    return out if b is None else out + b


def _replay_gap(k, n=96, products=3, promote=PROMOTE, m=64, seed=0):
    x, w, b = _operands(m, n, k, seed=seed)
    want = x.double() @ w.double().t() + b.double()
    got = _replay(x, w, b, products, promote)
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("k,n", [(1024, 96), (2730, 96), (1024, 170),
                                 (2730, 130)])
def test_3xtf32_promoted_replay_within_the_tolerance(k, n):
    """Three TF32 products a k-step, promoted every 16 k-steps: within
    ``LINEAR_TOL`` of the fp64 product (K = 2730: 341 k-steps and a tail of
    2 values; N = 170 and 130: a ragged last tile)."""
    assert _replay_gap(k, n) <= LINEAR_TOL


@pytest.mark.parametrize("k", [1024, 2730])
def test_1xtf32_replay_misses_the_tolerance(k):
    """One TF32 product a k-step lands a hundred times outside."""
    assert _replay_gap(k, products=1) > 100 * LINEAR_TOL


@pytest.mark.parametrize("k", [1024, 2730])
def test_unpromoted_replay_misses_the_tolerance(k):
    """One truncating accumulator over all of K, never promoted, lands
    outside: its bias toward zero grows with K."""
    assert _replay_gap(k, promote=0) > LINEAR_TOL


def test_replay_tail_is_exact_zero_padding():
    """The zero-filled k-tail and padded columns change nothing: K = 2730
    replayed against the same operands padded by hand to 2752 and N = 130
    to 256 with zeros, cut back."""
    x, w, b = _operands(8, 130, 2730, seed=2)
    xp = torch.zeros(8, 2752)
    xp[:, :2730] = x
    wp = torch.zeros(256, 2752)
    wp[:130, :2730] = w
    bp = torch.zeros(256)
    bp[:130] = b
    assert torch.equal(_replay(x, w, b), _replay(xp, wp, bp)[:, :130])
