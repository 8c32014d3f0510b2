"""The training directions of the port's kernels against the JAX package on
the CPU: the sampling backward (the plain version of
``csrc/msmv_sample_bwd.cu``) against ``jax.vjp`` of the ``custom_vjp`` op for
all three cotangents, the two pack adjoints against ``jax.vjp`` of the JAX
packs, ``gradcheck`` of the half-row primal, and the guard that keeps the
forward-only kernels out of a gradient. Inputs are made from a seed with
numpy and fed to both."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.ops.msmv_pack_pallas import (pack_level as jpack_level,
                                                pack_level_pair as jpack_pair)

from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.ops.autograd_guard import refuse_backward
from sparsebev_tpu_torch.ops.msmv_pack import (pack_level, pack_level_bwd,
                                               pack_level_bwd_plain,
                                               pack_level_pair,
                                               pack_level_pair_bwd,
                                               pack_level_pair_bwd_plain)

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")

torch.set_num_threads(1)

N = 6
LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2)]
C, G, T = 16, 2, 3
# the cases of the sampling backward: per-level table mode, group-split
# flags and an optional non-bijective logical -> physical slice map
CASES = {
    "yfold": dict(yfold=(True,) * 4, gsplit=False, slots=None),
    "pair_level": dict(yfold=(False, True, True, True), gsplit=False,
                       slots=None),
    "gsplit_level": dict(yfold=(True,) * 4,
                         gsplit=(False, True, False, False), slots=None),
    "slice_map": dict(yfold=(False, True, True, True), gsplit=False,
                      slots=[2, 0, 0]),
}


def _np(t):
    return t.detach().float().numpy()


def _locations(rng, q, s, p):
    loc = np.stack([rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.randint(0, N, (q, s, p)) / (N - 1)
                    + rng.uniform(-0.08, 0.08, (q, s, p))], -1)
    h0, w0 = LEVELS[0]
    # pixel floor at -1 (the shifted window) in x, in y and in both
    loc[0, :, 0, :2] = (-0.3 / (w0 - 1), 0.5)
    loc[1, :, 0, :2] = (0.5, -0.7 / (h0 - 1))
    loc[2, :, 0, :2] = (-0.2 / (w0 - 1), -0.9 / (h0 - 1))
    loc[3, :, 0, :2] = (0.97, 0.96)         # next to the last pixel
    loc[4, :, 0, :2] = (40.0, -30.0)        # far outside
    loc[5, :, 0, 2] = 1.6                   # view beyond N-1 (clipped)
    loc[6, :, 0, :2] = (0.5, (h0 - 1.5) / (h0 - 1))   # row ry+1 = H-1
    return loc.astype(np.float32)


def _setup(case, dtype, seed=0, q=9, p=2):
    """Raw pyramids, points, weights and an output cotangent; the JAX and
    the port's function of (features, loc, sw) -> sampled ``[Q, S, P, C]``."""
    cfg = CASES[case]
    rng = np.random.RandomState(seed)
    feats = [rng.randn(1, T * N, h, w, C * G).astype(np.float32)
             for h, w in LEVELS]
    s = T * G
    loc = _locations(rng, q, s, p)
    sw = rng.uniform(0.1, 1.0, (q, s, p, len(LEVELS))).astype(np.float32)
    gout = rng.randn(q, s, p, C).astype(np.float32)
    slots = cfg["slots"]

    def jax_fn(fs, lo, w_):
        packed = jms.pack_mlvl_feats_grouped(
            [f.astype(dtype) for f in fs], N, G, yfold=cfg["yfold"],
            gsplit=cfg["gsplit"])
        if slots is not None:
            packed = jms.ring_packed(packed.tables, jnp.asarray(slots), T,
                                     packed)
        return jms.msmv_sampling(packed, lo, w_, qmajor=True)

    def torch_fn(fs, lo, w_):
        packed = tms.pack_mlvl_feats_grouped(
            [f.to(getattr(torch, dtype)) for f in fs], N, G,
            yfold=cfg["yfold"], gsplit=cfg["gsplit"])
        if slots is not None:
            packed = tms.ring_packed(packed.tables, torch.tensor(slots), T,
                                     packed)
        return tms.msmv_sampling(packed, lo, w_)

    return feats, loc, sw, gout, jax_fn, torch_fn


def _both_vjps(case, dtype):
    feats, loc, sw, gout, jax_fn, torch_fn = _setup(case, dtype)
    out_j, vjp = jax.vjp(jax_fn, [jnp.asarray(f) for f in feats],
                         jnp.asarray(loc), jnp.asarray(sw))
    want = vjp(jnp.asarray(gout, out_j.dtype))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tl = torch.from_numpy(loc).requires_grad_()
    tw = torch.from_numpy(sw).requires_grad_()
    out_t = torch_fn(tf, tl, tw)
    assert out_t.grad_fn is not None
    got = torch.autograd.grad(out_t, tf + [tl, tw],
                              torch.from_numpy(gout).to(out_t.dtype))
    return want, got, len(feats)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampling_backward_matches_jax_vjp_fp32(case):
    """fp32 tables: d features (through the pack adjoints), d loc and d sw
    within 1e-5 of each cotangent's scale (fp32 sums in another order)."""
    (want_f, want_loc, want_sw), got, n = _both_vjps(case, "float32")
    for lvl in range(n):
        w_ = np.asarray(want_f[lvl])
        np.testing.assert_allclose(_np(got[lvl]), w_, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w_).max()))
    w_loc = np.asarray(want_loc)
    assert np.abs(w_loc[..., :2]).max() > 1.0     # a live gradient
    np.testing.assert_allclose(_np(got[n]), w_loc, rtol=0,
                               atol=1e-5 * np.abs(w_loc).max())
    assert not _np(got[n])[..., 2].any()          # the view gets none
    w_sw = np.asarray(want_sw)
    np.testing.assert_allclose(_np(got[n + 1]), w_sw, rtol=0,
                               atol=1e-5 * np.abs(w_sw).max())


# bf16 tables: JAX rounds every contribution to bf16 before its scatter-add
# and adds in bf16 (the cotangent of ``take(...).astype(float32)``); the
# port's plain version takes autograd over the tables in their own dtype,
# which rounds and adds the same way in the same (index) order. Measured on
# these cases: bit-equal at every level, so the tolerance is 0. d loc and
# d sw read bf16 tables and a bf16 cotangent in fp32 on both sides: 1e-5 of
# their scale.
BF16_TABLE_GRAD_TOL = 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampling_backward_matches_jax_vjp_bf16(case):
    (want_f, want_loc, want_sw), got, n = _both_vjps(case, "bfloat16")
    for lvl in range(n):
        w_ = np.asarray(want_f[lvl]).astype(np.float32)
        np.testing.assert_allclose(
            _np(got[lvl]), w_, rtol=0,
            atol=BF16_TABLE_GRAD_TOL * max(1.0, np.abs(w_).max()))
    w_loc = np.asarray(want_loc)
    np.testing.assert_allclose(_np(got[n]), w_loc, rtol=0,
                               atol=1e-5 * np.abs(w_loc).max())
    w_sw = np.asarray(want_sw)
    np.testing.assert_allclose(_np(got[n + 1]), w_sw, rtol=0,
                               atol=1e-5 * np.abs(w_sw).max())


def test_bf16_table_gradient_rounds_every_add_as_jax():
    """Nine points on one pixel of one view put 256 and then eight times 1.0
    into one bf16 table entry. JAX rounds every add to bf16 (256 + 1 is a
    tie and stays 256), so the entry reads 256; an fp32 sum rounded once
    reads 264. The port's sampling backward, on its own and through the
    pack's adjoint, gives JAX's bits."""
    h = w = 5                        # pixel = loc * 4: exact in fp32
    n, c, q = 2, 8, 9
    feats = [np.random.RandomState(0).randn(1, n, h, w, c).astype(np.float32)]
    loc = np.tile(np.float32([2 / (w - 1), 1 / (h - 1), 0.0]), (q, 1, 1, 1))
    sw = np.ones((q, 1, 1, 1), np.float32)
    gout = np.ones((q, 1, 1, c), np.float32)
    gout[0] = 256.0

    def jax_fn(fs):
        packed = jms.pack_mlvl_feats_grouped(fs, n, 1)
        return jms._msmv_yfold(True, packed, jnp.asarray(loc),
                               jnp.asarray(sw))

    out_j, vjp = jax.vjp(jax_fn, [jnp.asarray(feats[0], jnp.bfloat16)])
    want = np.asarray(vjp(jnp.asarray(gout, out_j.dtype))[0][0]).astype(
        np.float32)
    assert (want[0, 0, 1, 2] == 256.0).all()

    tf = torch.from_numpy(feats[0]).bfloat16().requires_grad_()
    packed = tms.pack_mlvl_feats_grouped([tf], n, 1)
    tgout = torch.from_numpy(gout).bfloat16()
    tms.msmv_sampling(packed, torch.from_numpy(loc),
                      torch.from_numpy(sw)).backward(tgout)
    np.testing.assert_array_equal(_np(tf.grad), want)
    (leaf,) = [t.detach() for t in packed.tables]
    d_table = torch.zeros_like(leaf)
    tms.msmv_sampling_backward(packed.replace(tables=[leaf]),
                               torch.from_numpy(loc), torch.from_numpy(sw),
                               tgout, [d_table])
    assert (d_table.view(n, h, w + 1, 2 * c)[0, 1, 2, :c] == 256).all()


def _six_calls(case, dtype, seed=0):
    """Raw pyramids and six (locations, weights, output gradient) triples:
    the six decoder layers that sample one packed pyramid."""
    feats = _setup(case, dtype, seed)[0]
    rng = np.random.RandomState(seed + 1)
    calls = [(_locations(rng, 9, T * G, 2),
              rng.uniform(0.1, 1.0, (9, T * G, 2, len(LEVELS))).astype(
                  np.float32),
              rng.randn(9, T * G, 2, C).astype(np.float32))
             for _ in range(6)]
    return feats, calls


def _six_call_grads(case, dtype, calls, feats, shared=True, passes=1):
    """Feature and point gradients of six sampling calls on one pyramid
    packed by ``pack_level`` / ``pack_level_pair``: with the packs'
    ``TableGrad`` (``shared``) or with autograd summing six table gradients
    (the tables rewrapped without it). With ``passes`` > 1: a backward pass
    for the first call's points alone, then ``passes`` full passes over the
    same retained graph; returns each full pass's gradients."""
    cfg = CASES[case]
    tdt = getattr(torch, dtype)
    tf = [torch.from_numpy(f).to(tdt).requires_grad_() for f in feats]
    packed = tms.pack_mlvl_feats_grouped(tf, N, G, yfold=cfg["yfold"],
                                         gsplit=cfg["gsplit"])
    assert all(g is not None for g in packed.table_grads)
    if not shared:
        packed = packed.replace(table_grads=None)
    locs = [torch.from_numpy(lo).requires_grad_() for lo, _, _ in calls]
    outs = [tms.msmv_sampling(packed, lo, torch.from_numpy(w_))
            for lo, (_, w_, _) in zip(locs, calls)]
    gouts = [torch.from_numpy(g).to(tdt) for _, _, g in calls]
    if passes == 1:
        return torch.autograd.grad(outs, tf + locs, gouts)
    torch.autograd.grad(outs, locs[:1], gouts, retain_graph=True)
    return [torch.autograd.grad(outs, tf + locs, gouts,
                                retain_graph=i < passes - 1)
            for i in range(passes)]


@pytest.mark.parametrize("case", ["yfold", "pair_level"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_six_sampling_calls_share_one_table_gradient(case, dtype):
    """One buffer a level for the six calls gives the feature gradient of
    six table gradients summed by autograd: the same adds in the same
    order (the last call's gradient first), so bit-equal in fp32 (the
    stated bound, 1e-6 of the scale, is not needed) and in bf16; in bf16
    it is also JAX's sum of the six per-call cotangents, bit for bit."""
    feats, calls = _six_calls(case, dtype)
    got = _six_call_grads(case, dtype, calls, feats)
    want = _six_call_grads(case, dtype, calls, feats, shared=False)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    if dtype == "float32":
        return
    cfg = CASES[case]

    def jax_fn(fs):
        packed = jms.pack_mlvl_feats_grouped(fs, N, G, yfold=cfg["yfold"],
                                             gsplit=cfg["gsplit"])
        return [jms.msmv_sampling(packed, jnp.asarray(lo), jnp.asarray(w_),
                                  qmajor=True) for lo, w_, _ in calls]

    outs, vjp = jax.vjp(jax_fn, [jnp.asarray(f, jnp.bfloat16) for f in feats])
    (jf,) = vjp([jnp.asarray(g, o.dtype) for o, (_, _, g) in zip(outs, calls)])
    for lvl, w_ in enumerate(jf):
        np.testing.assert_array_equal(_np(got[lvl]),
                                      np.asarray(w_).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_gradient_buffer_is_never_read_stale(dtype):
    """A backward pass for the points alone leaves a summed buffer that no
    pack reads; the two full passes after it on the same retained graph
    each start from zeros and give the gradients of a fresh graph."""
    feats, calls = _six_calls("pair_level", dtype, seed=4)
    want = _six_call_grads("pair_level", dtype, calls, feats)
    for got in _six_call_grads("pair_level", dtype, calls, feats, passes=2):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("reentrant", [False, True])
def test_checkpointed_sampling_calls_lose_no_table_gradient(reentrant):
    """Remat around every other of the six sampling calls, as a decoder
    layer remat would put it. A non-reentrant checkpoint runs the sampling
    backward in the outer pass; a reentrant one recomputes the call inside
    the outer pass and runs its backward in a nested pass, where the table
    gradient goes to autograd and the pack's adjoint of the nested pass.
    Either way the feature and point gradients equal those of the six calls
    without remat, within 1e-6 of their scale (fp32; the nested passes add
    in another order). Contributions lost to a buffer of another pass would
    show as a difference of the order of the gradient itself."""
    feats, calls = _six_calls("yfold", "float32", seed=2)
    want = _six_call_grads("yfold", "float32", calls, feats)
    cfg = CASES["yfold"]
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    packed = tms.pack_mlvl_feats_grouped(tf, N, G, yfold=cfg["yfold"],
                                         gsplit=cfg["gsplit"])
    locs = [torch.from_numpy(lo).requires_grad_() for lo, _, _ in calls]

    def sample(lo, w_):
        return tms.msmv_sampling(packed, lo, w_)

    outs = []
    for i, (lo, (_, w_, _)) in enumerate(zip(locs, calls)):
        w_ = torch.from_numpy(w_)
        outs.append(torch.utils.checkpoint.checkpoint(
            sample, lo, w_, use_reentrant=reentrant) if i % 2
            else sample(lo, w_))
    torch.autograd.backward(outs, [torch.from_numpy(g) for _, _, g in calls])
    for t, w_ in zip(tf + locs, want):
        np.testing.assert_allclose(_np(t.grad), _np(w_), rtol=0,
                                   atol=1e-6 * np.abs(_np(w_)).max())


def test_table_gradients_come_back_in_the_table_dtype():
    """A bf16 table that is itself the leaf gets a bf16 gradient (autograd
    refuses a bf16 leaf an fp32 one); without table gradients wanted the
    backward computes none."""
    feats, loc, sw, gout, _, _ = _setup("pair_level", "bfloat16")
    packed = tms.pack_mlvl_feats_grouped(
        [torch.from_numpy(f).bfloat16() for f in feats], N, G,
        yfold=CASES["pair_level"]["yfold"])
    for t in packed.tables:
        t.requires_grad_()
    out = tms.msmv_sampling(packed, torch.from_numpy(loc),
                            torch.from_numpy(sw))
    out.backward(torch.from_numpy(gout).bfloat16())
    for t in packed.tables:
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
        assert bool(t.grad.float().abs().sum() > 0)
    d_loc, d_sw = tms.msmv_sampling_backward(
        packed, torch.from_numpy(loc), torch.from_numpy(sw),
        torch.from_numpy(gout).bfloat16())
    assert d_loc.shape == loc.shape
    assert d_sw.shape == sw.shape


def test_forward_is_unchanged_when_nothing_needs_a_gradient():
    feats, loc, sw, _, _, torch_fn = _setup("gsplit_level", "float32")
    tf = [torch.from_numpy(f) for f in feats]
    plain = torch_fn(tf, torch.from_numpy(loc), torch.from_numpy(sw))
    assert plain.grad_fn is None
    tracked = torch_fn(tf, torch.from_numpy(loc).requires_grad_(),
                       torch.from_numpy(sw))
    assert tracked.grad_fn is not None
    assert torch.equal(plain, tracked.detach())
    with torch.no_grad():
        quiet = torch_fn(tf, torch.from_numpy(loc).requires_grad_(),
                         torch.from_numpy(sw))
    assert quiet.grad_fn is None


def test_halfrow_primal_matches_jax_and_the_window_forward():
    """``msmv_halfrow_plain`` against JAX ``_msmv_halfrow`` (fp32, 1e-5) and
    against the window forward it shadows."""
    feats, loc, sw, _, _, _ = _setup("slice_map", "float32")
    cfg = CASES["slice_map"]
    jp = jms.pack_mlvl_feats_grouped([jnp.asarray(f) for f in feats], N, G,
                                     yfold=cfg["yfold"])
    jp = jms.ring_packed(jp.tables, jnp.asarray(cfg["slots"]), T, jp)
    want = np.asarray(jms._msmv_halfrow(True, jp, jnp.asarray(loc),
                                        jnp.asarray(sw)))
    tp = tms.pack_mlvl_feats_grouped([torch.from_numpy(f) for f in feats],
                                     N, G, yfold=cfg["yfold"])
    tp = tms.ring_packed(tp.tables, torch.tensor(cfg["slots"]), T, tp)
    got = tms.msmv_halfrow_plain(tp, torch.from_numpy(loc),
                                 torch.from_numpy(sw))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)
    fwd = tms.msmv_sampling_plain(tp, torch.from_numpy(loc),
                                  torch.from_numpy(sw))
    np.testing.assert_allclose(_np(fwd), want, rtol=0, atol=tol)


def test_halfrow_primal_gradcheck_fp64():
    """``torch.autograd.gradcheck`` of the half-row primal in fp64, points
    kept away from the kinks of the piecewise-linear weights (pixel
    coordinates at least 0.1 from an integer) and from the view rounding."""
    rng = np.random.RandomState(3)
    levels = [(4, 6), (2, 3)]
    yfold = (False, True)
    q, s, p, c, g, n = 3, 2, 2, 4, 2, 2
    tables = []
    for (h, w), yf in zip(levels, yfold):
        rows = (s // g) * n * h * g
        tables.append(torch.from_numpy(
            rng.randn(rows, w + 1, (2 if yf else 1) * c)).requires_grad_())
    # pixel = loc * (size - 1); pick level-0 pixels with fractional part in
    # [0.3, 0.7]: the coarser level's pixels then stay off the integers too
    fx = rng.randint(-1, levels[0][1] - 1, (q, s, p)) \
        + rng.uniform(0.3, 0.7, (q, s, p))
    fy = rng.randint(-1, levels[0][0] - 1, (q, s, p)) \
        + rng.uniform(0.3, 0.7, (q, s, p))
    loc_np = np.stack([fx / (levels[0][1] - 1), fy / (levels[0][0] - 1),
                       rng.randint(0, n, (q, s, p)) / (n - 1)], -1)
    for (h, w) in levels[1:]:
        for a, size in ((loc_np[..., 0], w), (loc_np[..., 1], h)):
            frac = np.abs(a * (size - 1) - np.round(a * (size - 1)))
            assert frac.min() > 1e-3
    loc = torch.from_numpy(loc_np).requires_grad_()
    sw = torch.from_numpy(rng.uniform(0.2, 1.0, (q, s, p, 2))).requires_grad_()

    def fn(lo, w_, *tabs):
        packed = tms.PackedFeatures(tabs, s, n, levels, c, num_groups=g,
                                    yfold=yfold)
        return tms.msmv_halfrow_plain(packed, lo, w_)

    assert fn(loc, sw, *tables).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (loc, sw, *tables), eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


# ------------------------------------------------------ the pack adjoints --

PACK_SHAPES = [(3, 16, 12, 8, 4), (2, 7, 9, 16, 4), (1, 5, 5, 6, 2),
               (6, 1, 1, 64, 4), (2, 2, 3, 8, 1), (2, 3, 5, 64, 4)]


@pytest.mark.parametrize("m,h,w,c,g", PACK_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_level_adjoint_matches_jax_vjp_bitwise(m, h, w, c, g, dtype):
    """The y-fold pack's adjoint (plain version of ``msmv_pack_level_bwd``)
    gives the bits of ``jax.vjp(pack_level)``: fp32 and bf16, odd and tiny
    heights. The one add is a bf16 add in JAX and an add in dT's dtype
    here: the same bits."""
    rng = np.random.RandomState(h * 100 + w)
    x = rng.randn(m, h, w, c).astype(np.float32)
    dt = rng.randn(m, h, g, w + 1, 2 * c // g).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jpack_level(f, g), jnp.asarray(x, dtype))
    want = np.asarray(vjp(jnp.asarray(dt, dtype))[0]).astype(np.float32)
    tdt = torch.from_numpy(dt).to(getattr(torch, dtype))
    got = pack_level_bwd(tdt, g)
    assert got.dtype == tdt.dtype and got.shape == (m, h, w, c)
    np.testing.assert_array_equal(_np(got), want)
    assert torch.equal(got, pack_level_bwd_plain(tdt, g))
    # and through autograd of the pack itself
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    pack_level(tx, g).backward(tdt)
    np.testing.assert_array_equal(_np(tx.grad), want)


@pytest.mark.parametrize("m,h,w,c,g", PACK_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_pair_adjoint_matches_jax_vjp_bitwise(m, h, w, c, g, dtype):
    rng = np.random.RandomState(h * 100 + w + 1)
    x = rng.randn(m, h, w, c).astype(np.float32)
    dt = rng.randn(m, h, g, w + 1, c // g).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jpack_pair(f, g), jnp.asarray(x, dtype))
    want = np.asarray(vjp(jnp.asarray(dt, dtype))[0]).astype(np.float32)
    tdt = torch.from_numpy(dt).to(getattr(torch, dtype))
    got = pack_level_pair_bwd(tdt, g)
    assert got.dtype == tdt.dtype and got.shape == (m, h, w, c)
    np.testing.assert_array_equal(_np(got), want)
    assert torch.equal(got, pack_level_pair_bwd_plain(tdt, g))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    pack_level_pair(tx, g).backward(tdt)
    np.testing.assert_array_equal(_np(tx.grad), want)


def test_pack_adjoints_never_fall_back():
    dt = torch.empty((6, 4, 4, 6, 128), device="meta")
    for fn in (pack_level_bwd, pack_level_pair_bwd):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(dt, 4)
        assert fn.launches == 0
    with pytest.raises(ValueError, match="groups in the table gradient"):
        pack_level_bwd(torch.zeros(1, 2, 3, 4, 8), 4)


# ------------------------------------------- the forward-only kernels' guard --

def test_refuse_backward_guard():
    """The guard the forward-only CUDA wrappers (one-hot samplers, tap fold,
    batched mixing core) call on their operands: it raises exactly when a
    result without ``grad_fn`` would silently cut a gradient."""
    leaf = torch.zeros(3, requires_grad=True)
    plain = torch.zeros(3)
    refuse_backward("op", [plain, None, [plain, plain]])
    with pytest.raises(RuntimeError, match="op has no backward kernel"):
        refuse_backward("op", [plain, leaf])
    with pytest.raises(RuntimeError, match="no backward kernel"):
        refuse_backward("op", [plain, (plain, [leaf * 2])])
    with torch.no_grad():
        refuse_backward("op", [leaf])
    with torch.inference_mode():
        refuse_backward("op", [leaf])


def test_forward_only_wrappers_call_the_guard_on_their_cuda_branch():
    """No card here: read the wrappers' CUDA branches for the guard call."""
    import inspect

    from sparsebev_tpu_torch.ops import mixing, msmv_epilogue, msmv_onehot
    for fn in (msmv_onehot._onehot_cuda, msmv_onehot._onehot_levels_cuda,
               msmv_epilogue._tap_fold_cuda):
        assert "refuse_backward(" in inspect.getsource(fn), fn.__name__
    assert "refuse_backward(" in inspect.getsource(mixing._mixing_cuda)
    # the CPU path stays differentiable through the plain versions
    x = torch.randn(2, 2, 4, 8, requires_grad=True)
    m = torch.randn(2, 2, 8, 8)
    s = torch.randn(2, 2, 6, 4)
    out = mixing.mixing_core_batched(x, m, s)
    assert out.grad_fn is not None
