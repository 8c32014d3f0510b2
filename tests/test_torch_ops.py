"""The port's ops and modules against the JAX package on the CPU: the y-fold
pack (bit for bit against the Pallas kernel in interpret mode), the sampling
op (fp32, atol 1e-5), the projection and ``sampling_4d``, geometry, and the
decoder's building blocks. Inputs are made from a seed with numpy and fed to
both."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from sparsebev_tpu.ops import box_ops as jbox
from sparsebev_tpu.ops import geometry as jgeo
from sparsebev_tpu.ops.msmv_pack_pallas import pack_level_tpu

from sparsebev_tpu_torch.kernels import build
from sparsebev_tpu_torch.ops import box_ops, geometry, msmv_sampling as tms
from sparsebev_tpu_torch.ops import projection
from sparsebev_tpu_torch.ops.msmv_pack import pack_level

# the JAX ops package re-exports functions under its module names
jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")
jproj = importlib.import_module("sparsebev_tpu.ops.projection")

torch.set_num_threads(1)

N = 6
PC = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------- the pack --

@pytest.mark.parametrize("m,h,w,c,g", [
    (3, 16, 12, 8, 4), (2, 32, 7, 16, 4), (1, 16, 5, 6, 2),
    (6, 1, 2, 64, 4), (6, 2, 4, 64, 4), (6, 3, 5, 64, 4), (2, 5, 9, 256, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_pallas_kernel_bitwise(m, h, w, c, g, dtype):
    rng = np.random.RandomState(h * 100 + w)
    x = rng.randn(m, h, w, c).astype(np.float32)
    want = np.asarray(pack_level_tpu(jnp.asarray(x, dtype), g,
                                     interpret=True)).astype(np.float32)
    got = pack_level(torch.from_numpy(x).to(getattr(torch, dtype)), g)
    assert got.shape == (m, h, g, w + 1, 2 * (c // g))
    np.testing.assert_array_equal(_np(got), want)


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    feat = torch.empty((6, 4, 5, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pack_level(feat, 4)
    packed = tms.PackedFeatures([torch.empty((4, 6, 16), device="meta")], 1,
                                1, [(4, 5)], 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tms.msmv_sampling(packed, torch.empty((2, 1, 1, 3), device="meta"),
                          torch.empty((2, 1, 1, 1), device="meta"))
    assert pack_level.launches == 0 and tms.msmv_sampling.launches == 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import os
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("NVCC", str(tmp_path / "nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all(["msmv_pack", "msmv_sample"])
    assert os.path.isfile(os.path.join(build.CSRC_DIR, "msmv_sample.cu"))


# ------------------------------------------------------------ sampling op --

LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2)]
C, G, T_SLOTS = 16, 2, 4
SLOTS_OF_T = [2, 0, 0]          # logical frame -> ring slot (not a bijection)


def _locations(rng, q, s, p):
    loc = np.stack([rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.randint(0, N, (q, s, p)) / (N - 1)
                    + rng.uniform(-0.08, 0.08, (q, s, p))], -1)
    h0, w0 = LEVELS[0]
    # pixel floor at -1 on level 0 (shifted window) in x, y and both
    loc[0, :, 0, :2] = (-0.3 / (w0 - 1), 0.5)
    loc[1, :, 0, :2] = (0.5, -0.7 / (h0 - 1))
    loc[2, :, 0, :2] = (-0.2 / (w0 - 1), -0.9 / (h0 - 1))
    loc[3, :, 0, :2] = (1.0, 1.0)           # last pixel of every level
    loc[4, :, 0, :2] = (0.0, 0.0)
    loc[5, :, 0, :2] = (40.0, -30.0)        # far outside
    loc[6, :, 0, 2] = 1.6                   # view beyond N-1 (clipped)
    loc[7, :, 0, 2] = -0.4                  # view below 0 (clipped)
    return loc.astype(np.float32)


def _packed_pair(rng, dtype, gsplit):
    feats = [rng.randn(1, T_SLOTS * N, h, w, C).astype(np.float32)
             for h, w in LEVELS]
    jfeats = [jnp.asarray(f, dtype) for f in feats]
    jp = jms.pack_mlvl_feats_grouped(
        jfeats, N, G, gsplit=(False, True, False, False) if gsplit else False)
    jring = jms.ring_packed(jp.tables, jnp.asarray(SLOTS_OF_T), 3, jp)
    # the port packs one table per level whatever the gsplit layout
    tp = tms.pack_mlvl_feats_grouped(
        [torch.from_numpy(f).to(getattr(torch, dtype)) for f in feats], N, G)
    tring = tms.ring_packed(tp.tables, torch.tensor(SLOTS_OF_T), 3, tp.meta())
    return feats, jp, jring, tp, tring


@pytest.mark.parametrize("gsplit", [False, True])
def test_grouped_tables_match_jax(gsplit):
    rng = np.random.RandomState(1)
    _, jp, _, tp, _ = _packed_pair(rng, "float32", gsplit)
    assert tp.batch == jp.batch and tp.channels == jp.channels
    for lvl, tt in enumerate(tp.tables):
        jt = jp.tables[lvl]
        if isinstance(jt, jms.GroupSplitRing):
            # the port keeps one (b, t, n, h, g) table; the JAX chunks are
            # its per-group row subsets
            rows = tt.shape[0] // G
            for gi in range(G):
                np.testing.assert_array_equal(
                    _np(tt.reshape(rows, G, *tt.shape[1:])[:, gi]),
                    np.asarray(jt[gi]))
        else:
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))


@pytest.mark.parametrize("gsplit", [False, True])
def test_sampling_matches_jax_fp32(gsplit):
    rng = np.random.RandomState(2)
    _, _, jring, _, tring = _packed_pair(rng, "float32", gsplit)
    q, p = 9, 3
    s = 3 * G
    loc = _locations(rng, q, s, p)
    sw = rng.rand(q, s, p, len(LEVELS)).astype(np.float32)
    want = np.asarray(jms.msmv_sampling(jring, jnp.asarray(loc),
                                        jnp.asarray(sw), qmajor=True))
    got = tms.msmv_sampling(tring, torch.from_numpy(loc),
                            torch.from_numpy(sw))
    assert got.dtype == torch.float32 and got.shape == (q, s, p, C // G)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5)


def test_sampling_bf16_tables_match_jax():
    """bf16 tables: bf16 output, bf16 tap products and per-level rounding
    in the JAX order give the same bits as XLA on the CPU."""
    rng = np.random.RandomState(3)
    _, _, jring, _, tring = _packed_pair(rng, "bfloat16", False)
    q, p, s = 9, 3, 3 * G
    loc = _locations(rng, q, s, p)
    sw = rng.rand(q, s, p, len(LEVELS)).astype(np.float32)
    want = np.asarray(jms.msmv_sampling(jring, jnp.asarray(loc),
                                        jnp.asarray(sw), qmajor=True)
                      ).astype(np.float32)
    got = tms.msmv_sampling(tring, torch.from_numpy(loc),
                            torch.from_numpy(sw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def test_sampling_yfold_equals_oracle():
    """The y-fold op equals the readable per-level oracle, and the port's
    oracle equals the JAX oracle."""
    rng = np.random.RandomState(4)
    b, q, p = 2, 7, 3
    feats = [rng.randn(b, N, h, w, C).astype(np.float32) for h, w in LEVELS]
    loc = _locations(rng, 8, b, p).transpose(1, 0, 2, 3)[:, :q]
    sw = rng.rand(b, q, p, len(LEVELS)).astype(np.float32)
    want = np.asarray(jms.msmv_sampling_reference(
        [jnp.asarray(f) for f in feats], jnp.asarray(loc), jnp.asarray(sw)))
    ref = tms.msmv_sampling_reference([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(loc),
                                      torch.from_numpy(sw))
    np.testing.assert_allclose(_np(ref), want, rtol=0, atol=1e-5)
    packed = tms.pack_mlvl_feats_grouped([torch.from_numpy(f) for f in feats],
                                         N, 1)
    got = tms.msmv_sampling(packed,
                            torch.from_numpy(loc).permute(1, 0, 2, 3)
                            .contiguous(),
                            torch.from_numpy(sw).permute(1, 0, 2, 3)
                            .contiguous())
    np.testing.assert_allclose(_np(got.permute(1, 0, 2, 3)), _np(ref),
                               rtol=0, atol=1e-5)


def test_ring_update_and_table_dtype():
    rng = np.random.RandomState(5)
    feats = [torch.from_numpy(rng.randn(1, N, h, w, C).astype(np.float32))
             .to(torch.bfloat16) for h, w in LEVELS]
    fp = tms.pack_mlvl_feats_grouped(feats, N, G)
    ring = tms.ring_init(fp, 3)
    assert tms.ring_update(ring, fp, 1) is ring
    for r, t in zip(ring, fp.tables):
        rows = t.shape[0]
        assert r.dtype == torch.bfloat16 and r.shape[0] == 3 * rows
        assert not r[:rows].any() and not r[2 * rows:].any()
        assert torch.equal(r[rows:2 * rows], t)
    view = tms.ring_packed(ring, torch.tensor([1, 1]), 2, fp.meta())
    assert view.slice_map.tolist() == [2, 3, 2, 3]
    assert tms.table_acc_dtype(view) == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tms.set_sampling_impl("hybrid")


# ------------------------------------------------------- projection & co --

def _cameras(rng, image_h, image_w):
    from test_torch_streaming import make_cameras
    return make_cameras(rng, image_h, image_w)


def test_geometry_and_boxes_match_jax():
    from sparsebev_tpu.utils.version import VERSION as JV
    from sparsebev_tpu_torch.utils.version import VERSION as TV
    rng = np.random.RandomState(6)
    box = rng.randn(2, 11, 10).astype(np.float32)
    box[..., :3] = rng.rand(2, 11, 3)
    off = rng.uniform(-0.5, 0.5, (2, 11, 8, 3)).astype(np.float32)
    tb, to = torch.from_numpy(box), torch.from_numpy(off)
    pairs = [
        (jbox.decode_bbox(box, PC), box_ops.decode_bbox(tb, PC)),
        (jbox.denormalize_bbox(box), box_ops.denormalize_bbox(tb)),
        (jgeo.inverse_sigmoid(box * 1.2 - 0.1),
         geometry.inverse_sigmoid(tb * 1.2 - 0.1)),
    ]
    for version in ("v1.0.0", "v0.17.1"):
        JV.name = TV.name = version
        try:
            pairs.append((jproj.make_sample_points(box, off, PC),
                          projection.make_sample_points(tb, to, PC)))
        finally:
            JV.name = TV.name = "v1.0.0"
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("b,g,t", [(1, 2, 3), (2, 4, 2)])
def test_sampling_4d_matches_jax(b, g, t):
    """Includes the (B, G, T) weight-fold quirk (T != G) and the argmax
    (first valid) view choice; image 64x176 with 6 cameras whose fields of
    view overlap."""
    rng = np.random.RandomState(7 + t)
    q, p, image_h, image_w = 10, 3, 64, 176
    levels = [(16, 44), (8, 22)]
    cams = _cameras(rng, image_h, image_w)
    l2i = np.tile(cams[None], (b, t, 1, 1)).reshape(b, t * N, 4, 4)
    l2i[:, N:] += rng.randn(b, (t - 1) * N, 4, 4).astype(np.float32) * 0.5
    pts = np.stack([rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-30, 30, (q, b, g, t, p)),
                    rng.uniform(-3, 2, (q, b, g, t, p))], -1).astype(
                        np.float32)
    sw = rng.rand(b, q, g, t, p, len(levels)).astype(np.float32)
    feats = [rng.randn(b, t * N, h, w, 8 * g).astype(np.float32)
             for h, w in levels]
    jp = jms.pack_mlvl_feats_grouped([jnp.asarray(f) for f in feats], N, g)
    tp = tms.pack_mlvl_feats_grouped([torch.from_numpy(f) for f in feats],
                                     N, g)
    want = jproj.sampling_4d(None, jp, jnp.asarray(sw), jnp.asarray(l2i),
                             image_h, image_w, num_views=N,
                             sample_points_q=jnp.asarray(pts))
    got = projection.sampling_4d(torch.from_numpy(pts), tp,
                                 torch.from_numpy(sw), torch.from_numpy(l2i),
                                 image_h, image_w, num_views=N)
    assert tuple(got.shape) == (b, q, g, t * p, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-5)
    jloc, jvalid = jproj.project_points_qmajor(
        jnp.asarray(pts), jnp.asarray(l2i), image_h, image_w, N)
    tloc, tvalid = projection.project_points_qmajor(
        torch.from_numpy(pts), torch.from_numpy(l2i), image_h, image_w, N)
    np.testing.assert_array_equal(_np(tvalid), np.asarray(jvalid))
    np.testing.assert_allclose(_np(tloc), np.asarray(jloc), rtol=1e-6,
                               atol=1e-6)
    # the argmax choice is exercised: some points see several views
    assert 0.2 < float(np.asarray(jvalid).mean()) <= 1.0


# ------------------------------------------------------ decoder pieces --

def _flax_to_port(module, jparams, sd_map):
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd_map(jparams)
          .items()}
    module.load_state_dict(sd, strict=True)
    return module


def test_multihead_attention_matches_jax():
    from sparsebev_tpu.models.layers import MultiheadAttention as JMHA
    from sparsebev_tpu_torch.models.layers import MultiheadAttention
    rng = np.random.RandomState(8)
    b, q, c, h = 2, 9, 32, 8
    x = rng.randn(b, q, c).astype(np.float32)
    mask = rng.randn(b * h, q, q).astype(np.float32)
    jm = JMHA(c, h)
    params = unfreeze(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              attn_mask=jnp.asarray(mask)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3, params)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    attn_mask=jnp.asarray(mask))
    tm = _flax_to_port(MultiheadAttention(c, h), params, lambda p: {
        "attn.in_proj_weight": p["in_proj_weight"].T,
        "attn.in_proj_bias": p["in_proj_bias"],
        "attn.out_proj.weight": p["out_proj"]["linear"]["kernel"].T,
        "attn.out_proj.bias": p["out_proj"]["linear"]["bias"]})
    got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-5)


def test_adaptive_mixing_matches_jax():
    from sparsebev_tpu.models.decoder import AdaptiveMixing as JMix
    from sparsebev_tpu_torch.models.decoder import AdaptiveMixing
    rng = np.random.RandomState(9)
    b, q, g, p, c, o = 1, 5, 4, 6, 8, 16
    x = rng.randn(b, q, g, p, c).astype(np.float32)
    query = rng.randn(b, q, g * c).astype(np.float32)
    jm = JMix(in_dim=g * c, in_points=p, n_groups=g, out_points=o)
    params = unfreeze(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(query)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.2, params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(query))
    tm = _flax_to_port(
        AdaptiveMixing(g * c, p, n_groups=g, out_points=o), params,
        lambda pr: {f"{n}.{k2}": (v.T if k == "kernel" else v)
                    for n in ("parameter_generator", "out_proj")
                    for k, v in pr[n]["linear"].items()
                    for k2 in [{"kernel": "weight", "bias": "bias"}[k]]})
    got = tm(torch.from_numpy(x), torch.from_numpy(query))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-4)


def test_fpn_matches_jax():
    from sparsebev_tpu.models.fpn import FPN as JFPN
    from sparsebev_tpu_torch.models.fpn import FPN
    rng = np.random.RandomState(10)
    chans, shapes = (8, 16, 32), [(8, 12), (4, 6), (2, 3)]
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for c, (h, w) in zip(chans, shapes)]
    jm = JFPN(in_channels=chans, out_channels=8, num_outs=4)
    params = unfreeze(jm.init(jax.random.PRNGKey(0),
                              [jnp.asarray(x) for x in xs]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32) * 0.3, params)
    want = jm.apply({"params": params}, [jnp.asarray(x) for x in xs])
    from sparsebev_tpu_torch.utils.convert import _fpn
    sd = {}
    _fpn(sd, params, prefix="")
    tm = FPN(in_channels=chans, out_channels=8, num_outs=4)
    tm.load_state_dict(sd, strict=True)
    got = tm([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == 4
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_.permute(0, 2, 3, 1)),
                                   np.asarray(w_), rtol=0, atol=1e-4)
