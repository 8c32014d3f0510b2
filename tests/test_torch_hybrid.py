"""The hybrid sampling entry point against the JAX package on the CPU: the
one-hot sampler (the port's plain version, bit for bit against the Pallas
kernel in interpret mode under ``jax.jit``), the hybrid pack and slice-major
sampling (bf16 features bit for bit against jitted JAX; fp32 features to
1e-5, since jitted XLA rounds the y-fold levels' fp32 fold otherwise — the
one-hot levels are exact), the impl selector and ``sampling_4d``'s warning.
Inputs are made from a seed with numpy and fed to both packages."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.ops.msmv_pallas import onehot_sample_level as j_onehot

from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.ops import projection
from sparsebev_tpu_torch.ops.msmv_onehot import (onehot_sample_level,
                                                 onehot_sample_level_plain)

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")
jproj = importlib.import_module("sparsebev_tpu.ops.projection")

torch.set_num_threads(1)

B, N, Q, P, C = 2, 6, 8, 5, 64      # the shapes of tests/test_msmv_hybrid.py


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    jms.set_sampling_impl("xla")
    tms.set_sampling_impl("xla")


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------ the one-hot level --

def _onehot_args(rng, s, k, nv, h, w):
    """Point arrays of the JAX contract, with edge rows (iy0 = -1, H-1),
    x0 at both window edges and points that share one row."""
    iy0 = rng.randint(-1, h, (s, k))
    iy0[:, 0], iy0[:, 1] = -1, h - 1
    view = rng.randint(0, nv, (s, k))
    ly = rng.rand(s, k).astype(np.float32)
    lw = rng.rand(s, k).astype(np.float32)
    wy0 = ((1 - ly) * (iy0 >= 0) * lw).astype(np.float32)
    wy1 = (ly * (iy0 + 1 <= h - 1) * lw).astype(np.float32)
    rows0 = view * h + np.clip(iy0, 0, h - 1)
    rows1 = view * h + np.clip(iy0 + 1, 0, h - 1)
    x0 = rng.randint(0, w - 1, (s, k))
    x0[:, 2], x0[:, 3] = 0, w - 2
    wx0 = rng.rand(s, k).astype(np.float32)
    wx1 = rng.rand(s, k).astype(np.float32)
    wx1[:, 4] = 0.0
    return [a.astype(np.int32) if a.dtype.kind == "i" else a
            for a in (rows0, rows1, wy0, wy1, x0, wx0, wx1)]


@pytest.mark.parametrize("s,k,nv,h,w,c,qb", [
    (2, 37, 3, 5, 7, 16, 16),       # ragged K (not a multiple of qb)
    (3, 64, 6, 4, 11, 64, 32),
    (1, 5, 2, 1, 2, 8, 8),          # one row, two columns
])
def test_onehot_matches_pallas_kernel_bitwise(s, k, nv, h, w, c, qb):
    rng = np.random.RandomState(s * 100 + k)
    table = rng.randn(s, nv * h, w * c).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16)
    args = _onehot_args(rng, s, k, nv, h, w)
    want = np.asarray(jax.jit(lambda t, *a: j_onehot(
        t, *a, w=w, c=c, query_block=qb, interpret=True))(
            jt, *[jnp.asarray(a) for a in args]))
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(
        torch.bfloat16)
    got = onehot_sample_level(tt, *[torch.from_numpy(a) for a in args],
                              w=w, c=c)
    assert got.dtype == torch.float32 and got.shape == (s, k, c)
    np.testing.assert_array_equal(_np(got), want)


def test_onehot_wrapper_never_falls_back():
    meta = dict(device="meta")
    table = torch.empty((2, 12, 5 * 8), dtype=torch.bfloat16, **meta)
    ints = [torch.empty((2, 3), dtype=torch.int32, **meta)] * 3
    flts = [torch.empty((2, 3), **meta)] * 4
    with pytest.raises(ValueError, match="no kernel for device meta"):
        onehot_sample_level(table, ints[0], ints[1], flts[0], flts[1],
                            ints[2], flts[2], flts[3], w=5, c=8)
    assert onehot_sample_level.launches == 0
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(a) for a in _onehot_args(rng, 2, 7, 2, 6, 5)]
    cpu = torch.from_numpy(rng.randn(2, 12, 40).astype(np.float32)).to(
        torch.bfloat16)
    assert torch.equal(onehot_sample_level(cpu, *args, w=5, c=8),
                       onehot_sample_level_plain(cpu, *args, w=5, c=8))
    with pytest.raises(ValueError, match="must be bf16"):
        onehot_sample_level(cpu.float(), *args, w=5, c=8)


# -------------------------------------------------------- the hybrid path --

def _inputs(rng, shapes, loc_spread=1.4):
    feats = [rng.randn(B, N, h, w, C).astype(np.float32) for h, w in shapes]
    loc_xy = rng.rand(B, Q, P, 2).astype(np.float32) * loc_spread \
        - (loc_spread - 1) / 2
    view = rng.randint(0, N, (B, Q, P, 1)).astype(np.float32) / (N - 1)
    loc = np.concatenate([loc_xy, view], -1)
    loc[0, 0, :, :2] = (-0.5 / (shapes[-1][1] - 1), 1.0)  # x0 = -1, last row
    loc[0, 1, :, :2] = (1.0, -0.5 / (shapes[-1][0] - 1))  # last column, y0 = -1
    sw = rng.rand(B, Q, P, len(shapes)).astype(np.float32)
    return feats, loc, sw / sw.sum(-1, keepdims=True)


def _hybrid_both(feats, loc, sw, dtype):
    jms.set_sampling_impl("hybrid")
    tms.set_sampling_impl("hybrid")
    jf = [jnp.asarray(f, dtype) for f in feats]
    want = jax.jit(lambda fs: jms.msmv_sampling(
        jms.pack_mlvl_feats(fs), jnp.asarray(loc), jnp.asarray(sw)))(jf)
    tp = tms.pack_mlvl_feats([torch.from_numpy(f).to(getattr(torch, dtype))
                              for f in feats])
    got = tms.msmv_sampling(tp, torch.from_numpy(loc), torch.from_numpy(sw),
                            qmajor=False)
    return tp, np.asarray(want).astype(np.float32), got


@pytest.mark.parametrize("shapes,mxu", [
    ([(16, 44), (8, 22), (4, 11)], (True, True, True)),   # all one-hot
    ([(64, 176), (8, 22)], (False, True)),    # big level 0 on the y-fold path
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_matches_jax(shapes, mxu, dtype):
    rng = np.random.RandomState(len(shapes) * 10 + len(dtype))
    feats, loc, sw = _inputs(rng, shapes)
    tp, want, got = _hybrid_both(feats, loc, sw, dtype)
    assert tuple(t is not None for t in tp.mxu_tables) == mxu
    assert tuple(t is None for t in tp.tables) == mxu
    assert all(t.dtype == torch.bfloat16 for t in tp.mxu_tables if t is not None)
    # the accumulator follows table_acc_dtype: fp32 without a y-fold level 0
    acc = torch.bfloat16 if dtype == "bfloat16" and not mxu[0] \
        else torch.float32
    assert got.dtype == acc and got.shape == (B, Q, P, C)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    # and the readable oracle, to the bf16 tables' precision
    ref = tms.msmv_sampling_reference(
        [torch.from_numpy(f).to(getattr(torch, dtype)) for f in feats],
        torch.from_numpy(loc), torch.from_numpy(sw))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-2, atol=2e-2)


def test_hybrid_out_of_image_points_sample_zero():
    rng = np.random.RandomState(21)
    feats, loc, sw = _inputs(rng, [(64, 176), (8, 22), (4, 11)])
    loc[..., :2] = 5.0
    _, want, got = _hybrid_both(feats, loc, sw, "bfloat16")
    assert not got.float().any()
    np.testing.assert_array_equal(_np(got), want)


def test_hybrid_against_the_yfold_path():
    """The same inputs through the "xla" impl (y-fold tables for every
    level): equal to bf16 precision, the hybrid levels' tables and weights
    being bf16."""
    rng = np.random.RandomState(22)
    feats, loc, sw = _inputs(rng, [(16, 44), (8, 22)])
    tf = [torch.from_numpy(f) for f in feats]
    xla = tms.msmv_sampling(tms.pack_mlvl_feats(tf), torch.from_numpy(loc),
                            torch.from_numpy(sw), qmajor=False)
    assert xla.shape == (B, Q, P, C)
    tms.set_sampling_impl("hybrid")
    hyb = tms.msmv_sampling(tms.pack_mlvl_feats(tf), torch.from_numpy(loc),
                            torch.from_numpy(sw), qmajor=False)
    scale = float(xla.abs().max())
    np.testing.assert_allclose(_np(hyb), _np(xla), rtol=0,
                               atol=2 ** -7 * scale)
    with pytest.raises(ValueError, match="slice-major"):
        tms.msmv_sampling(tms.pack_mlvl_feats(tf),
                          torch.from_numpy(loc).transpose(0, 1),
                          torch.from_numpy(sw).transpose(0, 1))


def test_sampling_impl_selector():
    assert tms.get_sampling_impl() == "xla"
    tms.set_sampling_impl("hybrid")
    assert tms.get_sampling_impl() == "hybrid"
    with pytest.raises(ValueError, match="unknown sampling impl"):
        tms.set_sampling_impl("pallas")
    assert tms.get_sampling_impl() == "hybrid"
    assert tms._MXU_LEVEL_MAX_ELEMS == jms._MXU_LEVEL_MAX_ELEMS


def test_sampling_4d_warns_under_hybrid_and_uses_the_yfold_path():
    """Raw pyramids given to ``sampling_4d`` are packed without one-hot
    tables, with the JAX package's warning under "hybrid"; the result is
    the "xla" one (and the JAX package's)."""
    from test_torch_streaming import make_cameras
    rng = np.random.RandomState(23)
    b, g, t, q, p, image_h, image_w = 1, 2, 2, 10, 3, 64, 176
    levels = [(16, 44), (8, 22)]
    l2i = np.tile(make_cameras(rng, image_h, image_w)[None],
                  (b, t, 1, 1)).reshape(b, t * N, 4, 4)
    pts = np.stack([rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-3, 2, (q, b, g, t, p))], -1).astype(
                        np.float32)
    sw = rng.rand(b, q, g, t, p, len(levels)).astype(np.float32)
    # the list layout: [B*T*G, N, H, W, C] slices in (b, t, g) order
    feats = [rng.randn(b * t * g, N, h, w, 8).astype(np.float32)
             for h, w in levels]
    tf = [torch.from_numpy(f) for f in feats]
    args = (torch.from_numpy(sw), torch.from_numpy(l2i), image_h, image_w)
    xla = projection.sampling_4d(torch.from_numpy(pts),
                                 tms.pack_mlvl_feats_grouped(tf, N, 1), *args,
                                 num_views=N)
    tms.set_sampling_impl("hybrid")
    jms.set_sampling_impl("hybrid")
    with pytest.warns(UserWarning, match="has no effect on sampling_4d"):
        got = projection.sampling_4d(torch.from_numpy(pts), tf, *args,
                                     num_views=N)
    with pytest.warns(UserWarning, match="has no effect on sampling_4d"):
        want = jproj.sampling_4d(None, [jnp.asarray(f) for f in feats],
                                 jnp.asarray(sw), jnp.asarray(l2i), image_h,
                                 image_w, num_views=N,
                                 sample_points_q=jnp.asarray(pts))
    assert torch.equal(got, xla)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)
