"""Pair-mode tables against the JAX package on the CPU: the pair pack (bit
for bit against the Pallas kernel in interpret mode and ``_pack_pair_xla``),
mixed-mode sampling (a pair level 0 beside y-fold levels) with and without a
group-split level (fp32 to atol 1e-5; bf16 bit for bit against XLA under
``jit`` in both accumulation orders), the mixed-mode ring and ``sampling_4d``.
Inputs are made from a seed with numpy and fed to both."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.ops.msmv_pack_pallas import (_pack_pair_xla,
                                                pack_level_pair_tpu)

from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.ops import projection
from sparsebev_tpu_torch.ops.msmv_pack import (pack_level_pair,
                                               pack_level_pair_plain)

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")
jproj = importlib.import_module("sparsebev_tpu.ops.projection")

torch.set_num_threads(1)

N = 6
LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2)]
YFOLD = (False, True, True, True)
GSPLIT = (False, False, True, False)       # a group-split y-fold level
C, G, T_SLOTS = 16, 2, 4
SLOTS_OF_T = [2, 0, 0]          # logical frame -> ring slot (not a bijection)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------- the pack --

@pytest.mark.parametrize("m,h,w,c,g", [
    (3, 16, 12, 8, 4), (2, 7, 9, 16, 4), (1, 5, 5, 6, 2),
    (6, 1, 1, 64, 4), (6, 3, 5, 64, 4), (2, 5, 9, 256, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_pack_matches_pallas_kernel_bitwise(m, h, w, c, g, dtype):
    rng = np.random.RandomState(h * 100 + w)
    x = rng.randn(m, h, w, c).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(pack_level_pair_tpu(jx, g, interpret=True)
                      ).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(_pack_pair_xla(jx, g)).astype(np.float32), want)
    got = pack_level_pair(torch.from_numpy(x).to(getattr(torch, dtype)), g)
    assert got.shape == (m, h, g, w + 1, c // g)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), want)


def test_pair_pack_wrapper_never_falls_back():
    feat = torch.empty((6, 4, 5, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pack_level_pair(feat, 4)
    assert pack_level_pair.launches == 0
    # the plain version is what a CPU tensor takes
    x = torch.randn(2, 3, 4, 8)
    assert torch.equal(pack_level_pair(x, 2), pack_level_pair_plain(x, 2))


# ------------------------------------------------------------ sampling op --

def _locations(rng, q, s, p):
    loc = np.stack([rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.randint(0, N, (q, s, p)) / (N - 1)
                    + rng.uniform(-0.08, 0.08, (q, s, p))], -1)
    h0, w0 = LEVELS[0]
    # pixel floor at -1 on the pair level (shifted window) in x, y and both
    loc[0, :, 0, :2] = (-0.3 / (w0 - 1), 0.5)
    loc[1, :, 0, :2] = (0.5, -0.7 / (h0 - 1))
    loc[2, :, 0, :2] = (-0.2 / (w0 - 1), -0.9 / (h0 - 1))
    loc[3, :, 0, :2] = (1.0, 1.0)           # last pixel of every level
    loc[4, :, 0, :2] = (0.0, 0.0)
    loc[5, :, 0, :2] = (40.0, -30.0)        # far outside
    loc[6, :, 0, 2] = 1.6                   # view beyond N-1 (clipped)
    loc[7, :, 0, 2] = -0.4                  # view below 0 (clipped)
    loc[8, :, 0, :2] = (0.5, (h0 - 1.5) / (h0 - 1))   # row ry+1 = H-1
    return loc.astype(np.float32)


def _rings(rng, dtype, gsplit):
    """JAX ring view (group-split tables when ``gsplit``) and the port's
    one-table-per-level ring view of the same features."""
    feats = [rng.randn(1, T_SLOTS * N, h, w, C).astype(np.float32)
             for h, w in LEVELS]
    jp = jms.pack_mlvl_feats_grouped(
        [jnp.asarray(f, dtype) for f in feats], N, G, yfold=YFOLD,
        gsplit=GSPLIT if gsplit else False)
    jring = jms.ring_packed(jp.tables, jnp.asarray(SLOTS_OF_T), 3, jp)
    tp = tms.pack_mlvl_feats_grouped(
        [torch.from_numpy(f).to(getattr(torch, dtype)) for f in feats], N, G,
        yfold=YFOLD)
    tring = tms.ring_packed(tp.tables, torch.tensor(SLOTS_OF_T), 3,
                            tp.meta(gsplit=GSPLIT if gsplit else False))
    return jp, jring, tp, tring


def _sample_both(jring, tring, loc, sw):
    want = jax.jit(lambda r: jms.msmv_sampling(
        r, jnp.asarray(loc), jnp.asarray(sw), qmajor=True))(jring)
    got = tms.msmv_sampling(tring, torch.from_numpy(loc),
                            torch.from_numpy(sw))
    return np.asarray(want).astype(np.float32), got


@pytest.mark.parametrize("gsplit", [False, True])
def test_mixed_tables_match_jax(gsplit):
    rng = np.random.RandomState(11)
    jp, _, tp, _ = _rings(rng, "float32", gsplit)
    assert tp.yfold == YFOLD and tp.channels == jp.channels
    for lvl, tt in enumerate(tp.tables):
        jt = jp.tables[lvl]
        assert tt.shape[-1] == (2 if YFOLD[lvl] else 1) * (C // G)
        if isinstance(jt, jms.GroupSplitRing):
            rows = tt.shape[0] // G
            for gi in range(G):
                np.testing.assert_array_equal(
                    _np(tt.reshape(rows, G, *tt.shape[1:])[:, gi]),
                    np.asarray(jt[gi]))
        else:
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))


@pytest.mark.parametrize("gsplit", [False, True])
def test_mixed_sampling_matches_jax_fp32(gsplit):
    rng = np.random.RandomState(12)
    _, jring, _, tring = _rings(rng, "float32", gsplit)
    assert any(jring.gsplit) == gsplit
    q, p, s = 11, 3, 3 * G
    loc = _locations(rng, q, s, p)
    sw = rng.rand(q, s, p, len(LEVELS)).astype(np.float32)
    want, got = _sample_both(jring, tring, loc, sw)
    assert got.dtype == torch.float32 and got.shape == (q, s, p, C // G)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("gsplit", [False, True])
def test_mixed_sampling_bf16_bitwise_both_orders(gsplit):
    """bf16: the unsplit order (each pair y tap rounded and added on its
    own) and the group-major order (both y taps summed in fp32, one add)
    each give the bits XLA gives under ``jit`` on the CPU."""
    rng = np.random.RandomState(13)
    _, jring, _, tring = _rings(rng, "bfloat16", gsplit)
    q, p, s = 11, 3, 3 * G
    loc = _locations(rng, q, s, p)
    sw = rng.rand(q, s, p, len(LEVELS)).astype(np.float32)
    want, got = _sample_both(jring, tring, loc, sw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def test_pair_orders_differ_in_bf16_only():
    """The accumulation order is a real choice: in bf16 the two orders give
    other bits for some outputs (by at most a few bf16 ulps); in fp32 with
    the pair level first they agree to rounding."""
    rng = np.random.RandomState(14)
    q, p, s = 11, 3, 3 * G
    for dtype in ("bfloat16", "float32"):
        _, _, tp, _ = _rings(rng, dtype, False)
        loc = torch.from_numpy(_locations(rng, q, s, p))
        sw = torch.from_numpy(rng.rand(q, s, p, len(LEVELS)).astype(
            np.float32))
        outs = [tms.msmv_sampling(
            tms.ring_packed(tp.tables, torch.tensor(SLOTS_OF_T), 3,
                            tp.meta(gsplit=gs)), loc, sw).float()
            for gs in (False, GSPLIT)]
        diff = (outs[0] - outs[1]).abs()
        scale = outs[0].abs().max()
        if dtype == "bfloat16":
            assert (diff > 0).sum() > 0
            assert diff.max() <= 4 * 2 ** -8 * scale
        else:
            assert diff.max() <= 1e-6 * scale


# -------------------------------------------------------------- the ring --

def test_mixed_ring_matches_jax_group_split_ring():
    """A mixed-mode port ring (pair L0, y-fold L1-L3), written in rotated
    slot order and read through rotated and duplicate slot windows, samples
    as the JAX ring with ``table_gsplit`` on L2 does (bf16, bit for bit)."""
    rng = np.random.RandomState(15)
    t, q, p = 4, 11, 3
    feats = [rng.randn(1, t * N, h, w, C).astype(np.float32)
             for h, w in LEVELS]
    jf = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    tf = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    fp0 = jms.pack_mlvl_feats_grouped([f[:, :N] for f in jf], N, G,
                                      yfold=YFOLD)
    jmeta = jax.tree_util.tree_map(lambda _: None, fp0)
    jring = jms.ring_init(fp0, t, jnp.bfloat16, 1, GSPLIT)
    tring, tmeta = None, None
    for i, slot in enumerate((2, 0, 3, 1)):
        jfp = jms.pack_mlvl_feats_grouped(
            [f[:, i * N:(i + 1) * N] for f in jf], N, G, yfold=YFOLD)
        jring = jms.ring_update(jring, jfp, jnp.int32(slot))
        tfp = tms.pack_mlvl_feats_grouped(
            [f[:, i * N:(i + 1) * N] for f in tf], N, G, yfold=YFOLD)
        if tring is None:
            tmeta = tfp.meta(gsplit=GSPLIT)
            tring = tms.ring_init(tfp, t)
        assert tms.ring_update(tring, tfp, slot) is tring
    for lvl, r in enumerate(tring):
        assert r.shape[-1] == (2 if YFOLD[lvl] else 1) * (C // G)
    loc = _locations(rng, q, t * G, p)
    sw = rng.rand(q, t * G, p, len(LEVELS)).astype(np.float32)
    for slots in ((2, 0, 3, 1), (3, 3, 1, 1)):
        jr = jms.ring_packed(jring, jnp.asarray(slots, jnp.int32), t, jmeta)
        tr = tms.ring_packed(tring, torch.tensor(slots), t, tmeta)
        assert tr.yfold == YFOLD and tr.gsplit == GSPLIT
        want, got = _sample_both(jr, tr, loc, sw)
        np.testing.assert_array_equal(_np(got), want, err_msg=str(slots))


@pytest.mark.parametrize("gsplit", [False, True])
def test_mixed_sampling_4d_matches_jax(gsplit):
    """``sampling_4d``'s (b, g, t) repack keeps the table modes and the
    group-split flags (the JAX group-major path with T-long runs)."""
    from test_torch_streaming import make_cameras
    rng = np.random.RandomState(16)
    b, g, t, q, p, image_h, image_w = 1, 2, 3, 10, 3, 64, 176
    levels = [(16, 44), (8, 22)]
    cams = make_cameras(rng, image_h, image_w)
    l2i = np.tile(cams[None], (b, t, 1, 1)).reshape(b, t * N, 4, 4)
    pts = np.stack([rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-3, 2, (q, b, g, t, p))], -1).astype(
                        np.float32)
    sw = rng.rand(b, q, g, t, p, len(levels)).astype(np.float32)
    feats = [rng.randn(b, t * N, h, w, 8 * g).astype(np.float32)
             for h, w in levels]
    yfold, gs = (False, True), ((False, True) if gsplit else False)
    jp = jms.pack_mlvl_feats_grouped([jnp.asarray(f) for f in feats], N, g,
                                     yfold=yfold, gsplit=gs)
    tp = tms.pack_mlvl_feats_grouped([torch.from_numpy(f) for f in feats],
                                     N, g, yfold=yfold)
    want = jproj.sampling_4d(None, jp, jnp.asarray(sw), jnp.asarray(l2i),
                             image_h, image_w, num_views=N,
                             sample_points_q=jnp.asarray(pts))
    got = projection.sampling_4d(torch.from_numpy(pts), _with_gsplit(tp, gs),
                                 torch.from_numpy(sw), torch.from_numpy(l2i),
                                 image_h, image_w, num_views=N)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5)


def _with_gsplit(packed, gsplit):
    return tms.PackedFeatures(packed.tables, packed.batch, packed.num_views,
                              packed.level_shapes, packed.channels,
                              packed.num_groups, packed.slice_map,
                              yfold=packed.yfold, gsplit=gsplit)


def test_gsplit_needs_a_yfold_level():
    with pytest.raises(ValueError, match="requires a yfold level"):
        tms.PackedFeatures([None, None], 2, N, LEVELS[:2], 8, 2,
                           yfold=(False, True), gsplit=(True, False))
