"""Pretrained weights from a reference ``.pth`` into the port, against the
JAX package's porting on the CPU.

A seeded JAX backbone (ResNet-50; VoVNet V-39-eSE) and FPN are written as a
reference checkpoint: ``backbone.*`` and ``neck.*`` keys (the detector's
``img_`` prefix dropped, as pretraining checkpoints have them), BN
``num_batches_tracked`` counters and a classifier the detector does not
have, under ``state_dict``, with a top-level ``version`` tag. The JAX
package loads it with ``load_torch_checkpoint`` + ``port_torch_params`` +
``merge_pretrained``; the port with its ``load_torch_checkpoint`` +
``load_pretrained``. The port's weights must equal ``state_dict_from_jax``
of the JAX result bit for bit, the head keep its own weights, both packages
take the VERSION tag, and a shape mismatch stop both loaders the same way.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from sparsebev_tpu.models.fpn import FPN as JaxFPN
from sparsebev_tpu.models.resnet import ResNet as JaxResNet
from sparsebev_tpu.models.vovnet import VoVNet as JaxVoVNet
from sparsebev_tpu.utils import checkpoint_io as jckpt
from sparsebev_tpu.utils.version import VERSION as JAX_VERSION

from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.utils import checkpoint_io
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax
from sparsebev_tpu_torch.utils.version import VERSION

from test_torch_streaming import PC, noise_tree

torch.set_num_threads(1)

C = 32
BACKBONES = {
    "ResNet": dict(cfg=dict(type="ResNet", depth=50, frozen_stages=1),
                   module=lambda: JaxResNet(depth=50),
                   in_channels=[256, 512, 1024, 2048],
                   # the r50 config's remap of the reference keys
                   revise_keys=[("backbone", "img_backbone")]),
    "VoVNet": dict(cfg=dict(type="VoVNet", spec_name="V-39-eSE",
                            frozen_stages=1),
                   module=lambda: JaxVoVNet(spec_name="V-39-eSE"),
                   in_channels=[256, 512, 768, 1024], revise_keys=[]),
}


def _model_cfg(name):
    spec = BACKBONES[name]
    return dict(
        type="SparseBEV", compute_dtype="float32",
        img_backbone=dict(spec["cfg"]),
        img_neck=dict(type="FPN", in_channels=spec["in_channels"],
                      out_channels=C, num_outs=4),
        pts_bbox_head=dict(
            type="SparseBEVHead", num_classes=10, in_channels=C,
            num_query=16, num_frames=2, num_points=2, num_layers=1,
            num_levels=4, code_size=10, pc_range=PC, num_groups=4,
            mixer_out_points=8))


def _jax_trees(name, rng):
    """Seeded JAX backbone + FPN trees, in the detector's layout."""
    spec = BACKBONES[name]
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    bb = spec["module"]()
    bvars = unfreeze(jax.jit(bb.init)(jax.random.PRNGKey(0), x))
    feats = jax.jit(bb.apply)(bvars, x)
    fpn = JaxFPN(in_channels=spec["in_channels"], out_channels=C, num_outs=4)
    nvars = unfreeze(jax.jit(fpn.init)(jax.random.PRNGKey(1), feats))
    params = {"backbone": noise_tree(bvars["params"], rng),
              "neck": noise_tree(nvars["params"], rng)}
    stats = {"backbone": noise_tree(bvars["batch_stats"], rng)}
    return params, stats


def _write_reference_pth(path, params, stats, mutate=None):
    sd = state_dict_from_jax(params, stats)
    ref = {}
    for k, v in sd.items():
        ref[k[len("img_"):] if k.startswith(("img_backbone.", "img_neck."))
            else k] = v
        if k.endswith(".running_var"):
            ref[k[len("img_"):-len("running_var")] + "num_batches_tracked"] \
                = torch.tensor(1000)
    ref["backbone.fc.weight"] = torch.zeros(3, 4)
    if mutate:
        mutate(ref)
    torch.save({"state_dict": ref, "version": "v0.17.1",
                "meta": {"epoch": 24}}, path)


def _jax_load(path, name, params, stats):
    """The JAX package's porting of ``path`` merged onto zeros of the same
    trees (what ``tools/train.py`` does with freshly initialized ones)."""
    zeros = jax.tree_util.tree_map(np.zeros_like,
                                   {"params": params, "batch_stats": stats})
    sd = jckpt.load_torch_checkpoint(path)
    ported = jckpt.port_torch_params(
        sd, revise_keys=BACKBONES[name]["revise_keys"], backbone_type=name)
    merged = jckpt.merge_pretrained(zeros, ported)
    return state_dict_from_jax(merged["params"], merged["batch_stats"])


@pytest.fixture
def versions():
    old = VERSION.name, JAX_VERSION.name
    yield
    VERSION.name, JAX_VERSION.name = old


@pytest.mark.parametrize("name", ["ResNet", "VoVNet"])
def test_pretrained_weights_equal_the_jax_porting(tmp_path, name, versions,
                                                  caplog):
    rng = np.random.RandomState(len(name))
    params, stats = _jax_trees(name, rng)
    path = str(tmp_path / "pretrain.pth")
    _write_reference_pth(path, params, stats)

    want = _jax_load(path, name, params, stats)
    assert JAX_VERSION.name == "v0.17.1"

    model = random_init_(build_detector({"model": _model_cfg(name)},
                                        device="cpu"), 0)
    head_before = {k: v.clone() for k, v in model.state_dict().items()
                   if k.startswith("pts_bbox_head.")}
    VERSION.name = "v1.0.0"
    sd = checkpoint_io.load_torch_checkpoint(path)
    assert VERSION.name == "v0.17.1"
    with caplog.at_level(logging.WARNING):
        report = checkpoint_io.load_pretrained(
            model, sd, BACKBONES[name]["revise_keys"])
    got = model.state_dict()
    assert len(want) > 100 and set(want) <= set(got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
    # the head is not in the checkpoint: it keeps its own weights
    assert set(report["missing"]) == set(head_before)
    for k, v in head_before.items():
        assert torch.equal(got[k], v), k
    # the classifier is reported, the BN counters are not
    assert report["unexpected"] == ["img_backbone.fc.weight"]
    assert any("img_backbone.fc.weight" in m for m in caplog.messages)
    assert not any("num_batches_tracked" in m for m in caplog.messages)


@pytest.mark.parametrize("name", ["ResNet", "VoVNet"])
def test_a_shape_mismatch_stops_both_loaders(tmp_path, name, versions):
    rng = np.random.RandomState(7)
    params, stats = _jax_trees(name, rng)
    key = ("backbone.conv1.weight" if name == "ResNet"
           else "backbone.stem.stem_1/conv.weight")

    def widen(ref):
        w = ref[key]
        ref[key] = torch.cat([w, w[:1]], dim=0)

    path = str(tmp_path / "bad.pth")
    _write_reference_pth(path, params, stats, mutate=widen)
    with pytest.raises(ValueError, match="shape mismatch at"):
        _jax_load(path, name, params, stats)
    model = build_detector({"model": _model_cfg(name)}, device="cpu")
    with pytest.raises(ValueError, match=r"shape mismatch at "
                       r"img_backbone\.(conv1|stem\.stem_1/conv)\.weight"):
        checkpoint_io.load_pretrained(
            model, checkpoint_io.load_torch_checkpoint(path),
            BACKBONES[name]["revise_keys"])


def test_revise_keys_remap_in_order():
    sd = {"backbone.conv1.weight": 1, "head.fc.weight": 2}
    out = checkpoint_io.apply_revise_keys(sd, [("backbone", "img_backbone")])
    assert out == {"img_backbone.conv1.weight": 1, "head.fc.weight": 2}
    assert checkpoint_io.apply_revise_keys(
        sd, [("^backbone", "a"), ("^a", "b")]) == {
            "b.conv1.weight": 1, "head.fc.weight": 2}
