"""Every config under ``configs/`` in the port against the JAX package: the
port's ``Config`` loads it as JAX's does, ``models/detector.py::
_model_kwargs`` gives the constructor arguments that JAX's ``build_model``
gives its detector, and the port's module tree, built on the ``meta``
device, has exactly the state-dict keys and shapes that
``state_dict_from_jax`` makes of the JAX tree (``jax.eval_shape`` of the
detector's init). Shapes only: no weight is held in memory. This shows
that r101's 23-block layer3, its fifth FPN level and the 400-query config
are complete. The EVA02 config's tree is held by ``tests/test_torch_eva02*``.
"""

import copy
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sparsebev_tpu.builder as jax_builder
from sparsebev_tpu.config import Config as JaxConfig

from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.models.detector import SparseBEV, _model_kwargs
from sparsebev_tpu_torch.utils import convert

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, "configs", "*.py")))
EVA02 = "vit_eva02_1600x640_trainval_future.py"


def _load(name):
    path = os.path.join(REPO, "configs", name)
    return Config.fromfile(path), JaxConfig.fromfile(path)


def _jax_kwargs(cfg):
    """What JAX's ``build_model`` hands its detector (captured at its
    registry call) and the detector."""
    seen = {}
    real = jax_builder.build

    def capture(spec, registry):
        seen.update(spec)
        return real(spec, registry)

    jax_builder.build = capture
    try:
        model, _ = jax_builder.build_model(cfg)
    finally:
        jax_builder.build = real
    seen.pop("type")
    return seen, model


def _plain(x):
    """Config values as plain Python (tuples as lists; dtypes by name)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, type) or hasattr(x, "dtype") and hasattr(x, "name"):
        return jnp.dtype(x).name
    return x


def test_every_config_is_checked():
    assert "r101_nuimg_1408x512.py" in CONFIGS
    assert "r50_nuimg_704x256_400q_36ep.py" in CONFIGS
    assert len(CONFIGS) >= 9


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_as_jax_does(name):
    ours, ref = _load(name)
    assert ours.to_dict() == ref.to_dict()


@pytest.mark.parametrize("name", CONFIGS)
def test_model_kwargs_are_jax_builders(name):
    ours, ref = _load(name)
    want, _ = _jax_kwargs(ref)
    got = _model_kwargs(ours)
    assert _plain(got) == _plain(want)


def test_r101_kwargs():
    ours, _ = _load("r101_nuimg_1408x512.py")
    kw = _model_kwargs(ours)
    assert kw["img_backbone"]["depth"] == 101
    assert kw["img_backbone"]["with_cp"] is True
    assert kw["img_backbone"]["frozen_stages"] == 1
    assert kw["img_neck"]["num_outs"] == 5
    head = kw["pts_bbox_head"]
    assert head["num_levels"] == 5
    assert tuple(head["table_gsplit"]) == (False, False, True, False, False)
    assert tuple(head["table_gsplit_pack"]) == \
        (False, False, True, False, False)
    # the base's top-level num_levels stays 4
    assert ours.num_levels == 4


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != EVA02])
def test_module_tree_matches_jax_tree(name, monkeypatch):
    ours, ref = _load(name)
    _, jmodel = _jax_kwargs(copy.deepcopy(ref))
    head = ours.model["pts_bbox_head"]
    t = head.get("num_frames", head.get("transformer", {}).get("num_frames"))
    img = jax.ShapeDtypeStruct((1, t * 6, 64, 128, 3), jnp.float32)
    l2i = jax.ShapeDtypeStruct((1, t * 6, 4, 4), jnp.float32)
    td = jax.ShapeDtypeStruct((1, t), jnp.float32)
    shapes = jax.eval_shape(
        lambda *a: jmodel.init({"params": jax.random.PRNGKey(0),
                                "aug": jax.random.PRNGKey(1)}, *a,
                               train=False), img, l2i, td)
    # zero-stride views carry the shapes; the conversion's tensors are made
    # on the meta device, so nothing is allocated
    monkeypatch.setattr(convert, "_t",
                        lambda x: torch.empty(np.shape(x), device="meta"))
    as_views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in convert.state_dict_from_jax(
        as_views["params"], as_views.get("batch_stats", {})).items()}
    with torch.device("meta"):
        model = SparseBEV(**_model_kwargs(ours))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert got == want
    if name.startswith("r101"):
        assert sum(k.startswith("img_backbone.layer3.") and
                   k.endswith(".conv2.weight") for k in got) == 23
        assert "img_neck.fpn_convs.3.conv.weight" in got
