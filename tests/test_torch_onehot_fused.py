"""The fused one-hot entry (every one-hot level of a hybrid sampling call in
one step, point geometry included) on the CPU: its plain version through
the hybrid path against the JAX package (``set_sampling_impl("hybrid")``
under ``jax.jit``, the Pallas kernel in interpret mode), and against the
per-level entry it fuses.

Tolerances: bf16 features give the JAX bits (bf16 accumulator behind a
y-fold level 0, fp32 accumulator without one); fp32 features agree within
1e-5, since jitted XLA contracts the y-fold level's fp32 fold into FMAs
(the one-hot levels are exact). Inputs are made from a seed with numpy and
fed to both packages; the points include both image edges in x and y, the
bottom row, points far outside, and view coordinates half way between two
views."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu_torch.ops import msmv_onehot as oh
from sparsebev_tpu_torch.ops import msmv_sampling as tms

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")

torch.set_num_threads(1)

S, N, Q, P = 4, 5, 6, 4
ONEHOT_SHAPES = [(7, 9), (5, 5), (3, 3)]    # odd H and W
YFOLD_SHAPE = (9, 13)                       # level 0 when there is a prefix


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    jms.set_sampling_impl("xla")
    tms.set_sampling_impl("xla")


def _np(t):
    return t.detach().float().numpy()


def _points(rng, shapes):
    """Slice-major locations ``[S, Q, P, 3]`` with the cases that are easy
    to get wrong, placed on the pixel grid of the last level."""
    h, w = shapes[-1]
    xy = rng.rand(S, Q, P, 2).astype(np.float32) * 1.3 - 0.15
    view = rng.randint(0, N, (S, Q, P, 1)).astype(np.float32) / (N - 1)
    loc = np.concatenate([xy, view], -1)
    loc[0, 0, :, :2] = (0.0, 1.0)                     # x = 0, bottom row
    loc[0, 1, :, :2] = (1.0, 0.0)                     # x = 1 (ix0 = W-1)
    loc[0, 2, :, :2] = (-0.5 / (w - 1), 1.0 + 0.5 / (h - 1))   # ix0 = -1
    loc[0, 3, :, :2] = (1.0 + 0.5 / (w - 1), -0.5 / (h - 1))   # past x = 1
    loc[0, 4, :, :2] = (5.0, -7.0)                    # no tap in the image
    loc[1, 0, :, 2] = 0.5 / (N - 1)     # half way: rounds to view 0 (even)
    loc[1, 1, :, 2] = 1.5 / (N - 1)     # half way: rounds to view 2 (even)
    loc[1, 2, :, 2] = (1.3, -0.2, 1.0, 0.0)           # clipped to [0, N-1]
    return loc


def _inputs(seed, c, shapes):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(S, N, h, w, c).astype(np.float32) for h, w in shapes]
    sw = rng.rand(S, Q, P, len(shapes)).astype(np.float32)
    return feats, _points(rng, shapes), sw / sw.sum(-1, keepdims=True)


def _set_threshold(monkeypatch, c, prefix):
    """Level 0 stays y-fold exactly when ``prefix``: the gate sits at the
    largest one-hot level's size."""
    h, w = ONEHOT_SHAPES[0]
    limit = N * h * w * c
    monkeypatch.setattr(jms, "_MXU_LEVEL_MAX_ELEMS", limit)
    monkeypatch.setattr(tms, "_MXU_LEVEL_MAX_ELEMS", limit)
    return ([YFOLD_SHAPE] if prefix else []) + ONEHOT_SHAPES


def _hybrid_both(feats, loc, sw, dtype, sw_dtype="float32"):
    jms.set_sampling_impl("hybrid")
    tms.set_sampling_impl("hybrid")
    jf = [jnp.asarray(f, dtype) for f in feats]
    jsw = jnp.asarray(sw).astype(sw_dtype)
    want = jax.jit(lambda fs: jms.msmv_sampling(
        jms.pack_mlvl_feats(fs), jnp.asarray(loc), jsw))(jf)
    tp = tms.pack_mlvl_feats([torch.from_numpy(f).to(getattr(torch, dtype))
                              for f in feats])
    tsw = torch.from_numpy(sw).to(getattr(torch, sw_dtype))
    oh.onehot_sample_levels.launches = 0
    got = tms.msmv_sampling(tp, torch.from_numpy(loc), tsw, qmajor=False)
    assert oh.onehot_sample_levels.launches == 0     # the CPU launches nothing
    return tp, np.asarray(want).astype(np.float32), got


@pytest.mark.parametrize("c", [16, 64])
@pytest.mark.parametrize("dtype,prefix", [
    ("bfloat16", True),      # bf16 accumulator behind a y-fold level 0
    ("bfloat16", False),     # fp32 accumulator from zeros
    ("float32", True),
    ("float32", False),
])
def test_fused_plain_matches_jax_hybrid(monkeypatch, c, dtype, prefix):
    shapes = _set_threshold(monkeypatch, c, prefix)
    feats, loc, sw = _inputs(c + len(dtype) + prefix, c, shapes)
    tp, want, got = _hybrid_both(feats, loc, sw, dtype)
    onehot = tuple(t is not None for t in tp.mxu_tables)
    assert onehot == (False,) * prefix + (True,) * len(ONEHOT_SHAPES)
    acc = torch.bfloat16 if dtype == "bfloat16" and prefix else torch.float32
    assert got.dtype == acc and got.shape == (S, Q, P, c)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)
    assert not _np(got)[0, 4].any()                   # the far-out points


def test_fused_plain_takes_bf16_scale_weights(monkeypatch):
    shapes = _set_threshold(monkeypatch, 16, prefix=False)
    feats, loc, sw = _inputs(5, 16, shapes)
    _, want, got = _hybrid_both(feats, loc, sw, "bfloat16", "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)


def _fused_args(seed, c, acc_dtype, sw_levels=None, index=None):
    feats, loc, sw = _inputs(seed, c, ONEHOT_SHAPES)
    tables = [torch.from_numpy(f).reshape(S, N * h, w * c).to(torch.bfloat16)
              for f, (h, w) in zip(feats, ONEHOT_SHAPES)]
    rng = np.random.RandomState(seed + 1)
    out = torch.from_numpy(rng.randn(S * Q * P, c).astype(np.float32)).to(
        acc_dtype)
    if sw_levels is not None:       # wider weights, read through an index
        wide = rng.rand(S, Q, P, sw_levels).astype(np.float32)
        wide[..., index] = sw
        sw = wide
    return tables, torch.from_numpy(loc), torch.from_numpy(sw), out


@pytest.mark.parametrize("acc_dtype", [torch.bfloat16, torch.float32])
def test_fused_equals_the_per_level_entry_in_level_order(acc_dtype):
    """The fused entry is the per-level entry on each level's point
    arguments, each result cast to the accumulator's dtype and added in the
    order given; it writes ``out`` in place and reads each level's weights
    at ``level_index``."""
    c, index = 16, [4, 0, 2]
    tables, loc, sw, out = _fused_args(7, c, acc_dtype, 5, index)
    k = S * Q * P
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = oh._view_index(loc[..., 2].reshape(k), N)
    want = out.clone()
    for table, (h, w), idx in zip(tables, ONEHOT_SHAPES, index):
        args = oh._onehot_level_weights(x, y, view, sw[..., idx].reshape(k),
                                        h, w)
        res = oh.onehot_sample_level(
            table, *[a.reshape(S, Q * P) for a in args], w=w, c=c)
        want = want + res.reshape(k, c).to(acc_dtype)
    got = oh.onehot_sample_levels(tables, ONEHOT_SHAPES, index, loc, sw, out,
                                  N, c)
    assert got is out and got.dtype == acc_dtype
    assert torch.equal(got, want)
    if acc_dtype == torch.bfloat16:
        # a bf16 accumulator rounds after every level, so the order counts
        back = oh.onehot_sample_levels(
            tables[::-1], ONEHOT_SHAPES[::-1], index[::-1], loc, sw,
            _fused_args(7, c, acc_dtype, 5, index)[3], N, c)
        assert not torch.equal(back, got)
        torch.testing.assert_close(back.float(), got.float(), rtol=0,
                                   atol=2.0 ** -6 * float(got.abs().max()))


def test_fused_view_rounds_half_to_even():
    v = torch.tensor([0.5, 1.5, 2.5, 3.5, -0.5, 4.5]) / (N - 1)
    assert oh._view_index(v, N).tolist() == [0, 2, 2, 4, 0, 4]


def test_fused_wrapper_never_falls_back():
    c = 16
    tables, loc, sw, out = _fused_args(3, c, torch.float32)
    index = [0, 1, 2]
    meta = [t.to("meta") for t in tables]
    oh.onehot_sample_levels.launches = 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        oh.onehot_sample_levels(meta, ONEHOT_SHAPES, index, loc.to("meta"),
                                sw.to("meta"), out.to("meta"), N, c)
    assert oh.onehot_sample_levels.launches == 0
    got = oh.onehot_sample_levels(tables, ONEHOT_SHAPES, index, loc, sw,
                                  out.clone(), N, c)
    want = oh.onehot_sample_levels_plain(tables, ONEHOT_SHAPES, index, loc,
                                         sw, out.clone(), N, c)
    assert torch.equal(got, want) and oh.onehot_sample_levels.launches == 0


@pytest.mark.parametrize("change,match", [
    (dict(tables="float"), "must be bf16"),
    (dict(index=[0, 1, 3]), "weight index 3 is outside"),
    (dict(index=[0, 1]), "3 tables, 3 shapes and 2 weight indices"),
    (dict(shapes=[(7, 9), (5, 5), (3, 4)]), r"is not \[S=4, N\*H, W\*C\]"),
    (dict(out=torch.float16), "accumulator"),
    (dict(sw=torch.float64), "scale weights must be bf16 or fp32"),
    (dict(views=N + 1), r"is not \[S=4, N\*H, W\*C\]"),
])
def test_fused_refuses_what_it_cannot_run(change, match):
    c = 16
    tables, loc, sw, out = _fused_args(4, c, torch.float32)
    if "tables" in change:
        tables = [t.float() for t in tables]
    if "out" in change:
        out = out.to(change["out"])
    if "sw" in change:
        sw = sw.to(change["sw"])
    with pytest.raises(ValueError, match=match):
        oh.onehot_sample_levels(tables, change.get("shapes", ONEHOT_SHAPES),
                                change.get("index", [0, 1, 2]), loc, sw, out,
                                change.get("views", N), c)
