"""The port's VoVNet against the JAX VoVNet on the CPU, fp32: V-99-eSE (the
1600x640 config's spec), two more non-depthwise specs and the two depthwise
specs at small odd and even image sizes (the ceil-mode pool), with seeded
noise on every param and batch stat carried over by ``state_dict_from_jax``,
and a detector's frame pass on each depthwise spec. The module's keys are
the reference's: the JAX package's ``_port_vovnet`` reads them back into
the JAX tree (it has no depthwise keys; the depthwise modules take the
reference's ``dw_conv3x3`` names)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.models.vovnet import VoVNet as JaxVoVNet
from sparsebev_tpu.utils.checkpoint_io import _port_vovnet

from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.models.vovnet import VoVNet
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_runner import MODEL as VOV_MODEL
from test_torch_streaming import REPO, noise_tree

torch.set_num_threads(1)

OUTS = ("stem", "stage2", "stage3", "stage4", "stage5")
# fp32 through up to 99 convolutions: the two frameworks sum the
# convolutions in other orders; relative to each output's scale
RTOL = 1e-4


def _jax_vovnet(spec, x, rng):
    jm = JaxVoVNet(spec_name=spec, out_features=OUTS)
    variables = unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    return jm, {"params": noise_tree(variables["params"], rng),
                "batch_stats": noise_tree(variables["batch_stats"], rng)}


@pytest.mark.parametrize("spec,h,w", [
    ("V-99-eSE", 67, 93), ("V-39-eSE", 64, 96), ("V-19-slim-eSE", 70, 101),
    ("V-19-slim-dw-eSE", 66, 99), ("V-19-dw-eSE", 64, 90),
])
def test_vovnet_matches_jax_fp32(spec, h, w):
    rng = np.random.RandomState(len(spec) + h)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    jm, variables = _jax_vovnet(spec, x, rng)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    sd = state_dict_from_jax({"backbone": variables["params"]},
                             {"backbone": variables["batch_stats"]})
    tm = VoVNet(spec_name=spec, out_features=OUTS)
    tm.load_state_dict({k[len("img_backbone."):]: v for k, v in sd.items()},
                       strict=True)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)
             .contiguous(memory_format=torch.channels_last))
    assert len(got) == len(want) == 5
    for name, g_, w_ in zip(OUTS, got, want):
        w_ = np.asarray(w_)
        g_ = g_.permute(0, 2, 3, 1).detach().numpy()
        assert g_.shape == w_.shape, name
        scale = np.abs(w_).max()
        assert scale > 1e-3, name
        np.testing.assert_allclose(g_, w_, rtol=0, atol=RTOL * scale,
                                   err_msg=name)


def test_vovnet_keys_are_the_reference_keys():
    """``_port_vovnet`` of the port's state dict rebuilds the JAX tree."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    _, variables = _jax_vovnet("V-39-eSE", x, rng)
    tm = VoVNet(spec_name="V-39-eSE")
    sd = state_dict_from_jax({"backbone": variables["params"]},
                             {"backbone": variables["batch_stats"]})
    tm.load_state_dict({k[len("img_backbone."):]: v for k, v in sd.items()},
                       strict=True)
    keys = set(tm.state_dict())
    for key in ("stem.stem_1/conv.weight", "stem.stem_3/norm.running_var",
                "stage2.OSA2_1.layers.0.OSA2_1_0/conv.weight",
                "stage2.OSA2_1.concat.OSA2_1_concat/norm.weight",
                "stage4.OSA4_2.ese.fc.bias"):
        assert key in keys, key
    params, stats = _port_vovnet(
        {k: v.numpy() for k, v in tm.state_dict().items()}, "")
    flat_j = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        {"params": params, "batch_stats": stats}))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_t[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_vov99_config_builds_with_finite_bf16_features():
    """The 1600x640 config's detector (V-99-eSE, FPN 256 x 5, pair L0) with
    seeded random weights gives finite, non-degenerate bf16 features through
    all 16 OSA blocks, and its frame pack writes a pair level 0."""
    cfg = Config.fromfile(f"{REPO}/configs/"
                          "vov99_dd3d_1600x640_trainval_future.py")
    model = build_detector(cfg, device="cpu", seed=0)
    assert model.compute_dtype == torch.bfloat16
    head = model.pts_bbox_head
    assert head.table_yfold == (False, True, True, True, True)
    assert head.table_gsplit == (False, False, False, True, False)
    img = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, 6, 64, 96, 3)).astype(np.uint8))
    with torch.no_grad():
        feats = model.extract_feat(model.preprocess(img))
        fp = model.forward_frame_packed(img)
    assert [tuple(f.shape[2:4]) for f in feats] == \
        [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    for f in feats:
        assert f.dtype == torch.bfloat16 and bool(torch.isfinite(f).all())
        assert 0.01 < f.float().std().item() < 100
    assert fp.yfold == head.table_yfold
    assert fp.tables[0].shape == (6 * 16 * 4, 25, 64)
    assert fp.tables[1].shape == (6 * 8 * 4, 13, 128)


def test_depthwise_keys_are_the_reference_names():
    """The depthwise modules under the reference's ``dw_conv3x3`` names:
    the stem's second and third convs and every OSA layer depthwise (one
    group a channel) then pointwise; the 1x1 reduction where a block's input
    is not its stage width (stage 2 of V-19-slim-dw-eSE takes the stem's 64
    channels as they are, as in JAX)."""
    tm = VoVNet(spec_name="V-19-slim-dw-eSE")
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes["stem.stem_1/conv.weight"] == (64, 3, 3, 3)
    assert shapes["stem.stem_3/dw_conv3x3.weight"] == (64, 1, 3, 3)
    assert shapes["stem.stem_3/pw_conv1x1.weight"] == (64, 64, 1, 1)
    assert shapes["stem.stem_3/pw_norm.running_var"] == (64,)
    assert shapes["stage2.OSA2_1.layers.0.OSA2_1_0/dw_conv3x3.weight"] \
        == (64, 1, 3, 3)
    assert shapes["stage3.OSA3_1.conv_reduction.OSA3_1_reduction_0/conv."
                  "weight"] == (80, 112, 1, 1)
    assert shapes["stage3.OSA3_1.layers.2.OSA3_1_2/pw_conv1x1.weight"] \
        == (80, 80, 1, 1)
    assert shapes["stage3.OSA3_1.concat.OSA3_1_concat/conv.weight"] \
        == (256, 112 + 3 * 80, 1, 1)
    assert not any(k.startswith("stage2.OSA2_1.conv_reduction")
                   for k in shapes)
    assert not any("/conv." in k for k in shapes
                   if ".layers." in k or "stem_2" in k or "stem_3" in k)


@pytest.mark.parametrize("spec,channels", [
    ("V-19-slim-dw-eSE", [112, 256, 384, 512]),
    ("V-19-dw-eSE", [256, 512, 768, 1024]),
])
def test_depthwise_frame_pass_matches_jax(spec, channels):
    """A detector on a depthwise spec (the small VoVNet model of
    ``test_torch_runner.py``, fp32): ``forward_frame_packed`` of one frame
    of six views, the packed tables of every level against JAX's within
    ``RTOL`` of their scale. The JAX tree's layout comes from
    ``jax.eval_shape`` of the init, filled with seeded noise."""
    cfg = dict(VOV_MODEL, img_backbone=dict(VOV_MODEL["img_backbone"],
                                            spec_name=spec),
               img_neck=dict(VOV_MODEL["img_neck"], in_channels=channels))
    jcfg = {k: v for k, v in cfg.items() if k not in ("type",
                                                      "compute_dtype")}
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **jcfg)
    rng = np.random.RandomState(len(spec))
    t = cfg["pts_bbox_head"]["num_frames"]
    img = rng.randint(0, 256, (1, 6, 64, 96, 3)).astype(np.float32)
    layout = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((1, 6 * t, 64, 96, 3)),
                              jnp.zeros((1, 6 * t, 4, 4)),
                              jnp.zeros((1, t)), train=False),
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)})
    variables = {k: noise_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), layout[k]), rng)
        for k in ("params", "batch_stats")}
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, method=jmodel.forward_frame_packed))(
        variables, jnp.asarray(img))
    model = build_detector({"model": cfg}, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model.forward_frame_packed(torch.from_numpy(img))
    assert len(got.tables) == len(want.tables) == 4
    for lvl, (g_, w_) in enumerate(zip(got.tables, want.tables)):
        w_ = np.asarray(w_)
        assert tuple(g_.shape) == w_.shape, lvl
        scale = np.abs(w_).max()
        assert scale > 1e-3, lvl
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0,
                                   atol=RTOL * scale, err_msg=str(lvl))
