"""The port's VoVNet against the JAX VoVNet on the CPU, fp32: V-99-eSE (the
1600x640 config's spec) and two more non-depthwise specs at small odd and
even image sizes (the ceil-mode pool), with seeded noise on every param and
batch stat carried over by ``state_dict_from_jax``. The module's keys are the
reference's: the JAX package's ``_port_vovnet`` reads them back into the JAX
tree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from sparsebev_tpu.models.vovnet import VoVNet as JaxVoVNet
from sparsebev_tpu.utils.checkpoint_io import _port_vovnet

from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.models.vovnet import VoVNet
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

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


def test_depthwise_specs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VoVNet(spec_name="V-19-dw-eSE")
