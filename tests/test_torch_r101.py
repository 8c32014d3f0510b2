"""ResNet-101 (``configs/r101_nuimg_1408x512.py``) in the port against the JAX
package on the CPU, with the JAX weights carried across by
``state_dict_from_jax`` after seeded noise on every leaf:

- the ResNet-101 and the 5-output FPN in fp32 at 96x160, whose top levels
  are odd (3x5, and the extra level's 2x3: the port's ``[::2, ::2]`` against
  JAX's stride-2 max pool of window 1), each level within 1e-4 of its scale;
- under ``with_cp`` (``torch.utils.checkpoint`` a bottleneck, ``nn.remat``
  in JAX), the gradients of a fixed scalar of the 5 outputs with respect to
  every backbone and neck parameter against ``jax.grad``, the frozen stage
  included (both packages freeze it through the optimizer's multipliers,
  not by stopping its gradient), and the optimizer's frozen set for
  ``frozen_stages`` 1 (the r101 config's) equal to JAX's;
- a reference ``.pth`` of the ResNet-101 and FPN (``backbone.*`` /
  ``neck.*`` keys, 23 bottlenecks in layer3) loaded by the port's
  ``load_pretrained`` bit-equal to the JAX package's porting;
- a 3-sample stream of a small r101 SparseBEV (FPN 64 channels, Q=16, T=2,
  2 layers, 5 levels with a group-split L2, 64x128 images) against JAX's
  ``StreamingDetector``.

The JAX trees come from ``jax.eval_shape`` (no init compile); one module
fixture each jits the JAX ResNet-101 once."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import StreamingDetector as JaxStreaming
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.models.fpn import FPN as JaxFPN
from sparsebev_tpu.models.resnet import ResNet as JaxResNet
from sparsebev_tpu.train import optim as joptim

from sparsebev_tpu.utils.version import VERSION as JAX_VERSION

from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.models.fpn import FPN
from sparsebev_tpu_torch.models.resnet import ResNet
from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.utils import checkpoint_io
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)
from sparsebev_tpu_torch.utils.version import VERSION

from test_torch_pretrained import _jax_load, _write_reference_pth
from test_torch_streaming import NORM, PC, make_cameras, noise_tree

torch.set_num_threads(1)

IN_CHANNELS = [256, 512, 1024, 2048]
C = 64
# fp32 through 101 convolutions and the FPN: the two frameworks sum the
# convolutions in other orders; relative to each level's (or gradient's)
# scale
RTOL = 1e-4
GRAD_RTOL = 1e-4


def _noised(shapes, rng):
    """Seeded noise on a tree of ``jax.eval_shape`` leaves."""
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    return noise_tree(zeros, rng)


# ------------------------------------------------- backbone and neck --

@pytest.fixture(scope="module")
def backbone_neck():
    rng = np.random.RandomState(101)
    x = rng.randn(1, 96, 160, 3).astype(np.float32)
    jbb = JaxResNet(depth=101, with_cp=True)
    jneck = JaxFPN(in_channels=IN_CHANNELS, out_channels=C, num_outs=5)
    bb_shapes = jax.eval_shape(jbb.init, jax.random.PRNGKey(0),
                               jnp.asarray(x))
    feat_shapes = jax.eval_shape(jbb.apply, bb_shapes, jnp.asarray(x))
    neck_shapes = jax.eval_shape(jneck.init, jax.random.PRNGKey(1),
                                 feat_shapes)
    params = {"backbone": _noised(bb_shapes["params"], rng),
              "neck": _noised(neck_shapes["params"], rng)}
    stats = {"backbone": _noised(bb_shapes["batch_stats"], rng)}
    out_shapes = jax.eval_shape(
        lambda p: jneck.apply({"params": p["neck"]}, jbb.apply(
            {"params": p["backbone"], "batch_stats": stats["backbone"]},
            jnp.asarray(x))), params)
    cot = [rng.randn(*s.shape).astype(np.float32) for s in out_shapes]

    def outputs_and_scalar(p):
        feats = jbb.apply({"params": p["backbone"],
                           "batch_stats": stats["backbone"]}, jnp.asarray(x))
        outs = jneck.apply({"params": p["neck"]}, feats)
        return sum((o * w).sum() for o, w in zip(outs, cot)), outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        outputs_and_scalar, has_aux=True))(params)

    sd = state_dict_from_jax(params, stats)
    tbb = ResNet(depth=101, with_cp=True)
    tneck = FPN(in_channels=IN_CHANNELS, out_channels=C, num_outs=5)
    for mod, prefix in ((tbb, "img_backbone."), (tneck, "img_neck.")):
        mod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                             if k.startswith(prefix)}, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    touts = tneck(tbb(xt))
    scalar = sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
                 for o, w in zip(touts, cot))
    scalar.backward()
    tgrads = {f"{prefix}{n}": p.grad for mod, prefix in
              ((tbb, "img_backbone."), (tneck, "img_neck."))
              for n, p in mod.named_parameters()}
    tgrad_tree, _ = jax_trees_from_state_dict(tgrads, params, stats)
    return (jouts, [o.detach().permute(0, 2, 3, 1).numpy() for o in touts],
            jgrads, tgrad_tree, tbb, params, stats)


def test_r101_has_23_block_layer3(backbone_neck):
    tbb = backbone_neck[4]
    assert [len(getattr(tbb, f"layer{s}")) for s in (1, 2, 3, 4)] == \
        [3, 4, 23, 3]


@pytest.mark.parametrize("level", range(5))
def test_r101_fpn_level_matches_jax(backbone_neck, level):
    jouts, touts = backbone_neck[0], backbone_neck[1]
    want, got = np.asarray(jouts[level]), touts[level]
    # 96x160: 24x40, 12x20, 6x10, 3x5 and the extra level 2x3
    assert got.shape == want.shape == \
        (1, *[(24, 40), (12, 20), (6, 10), (3, 5), (2, 3)][level], C)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_r101_fpn_gradients_match_jax_grad(backbone_neck):
    jgrads, tgrads = backbone_neck[2], backbone_neck[3]
    want = dict(_leaves(jax.device_get(jgrads)))
    got = dict(_leaves(tgrads))
    assert set(got) == set(want)
    # every bottleneck of layer3, and the frozen stage's gradients too
    assert sum(k.startswith("backbone/layer3_") and k.endswith("conv2/kernel")
               for k in got) == 23
    assert np.abs(want["backbone/layer1_0/conv1/kernel"]).max() > 0
    for key, w in want.items():
        g = got[key]
        assert g is not None and g.shape == w.shape, key
        scale = np.abs(w).max()
        assert scale > 0, key
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=key)


@pytest.mark.parametrize("frozen_stages", [-1, 1, 3])
def test_r101_frozen_parameters_match_jax(backbone_neck, frozen_stages):
    """The backbone parameters the port's optimizer gives lr 0 are those
    JAX's multiplier tree sets to 0 (the stem and stages 1..k), carried to
    the port's keys by ``state_dict_from_jax``."""
    params = backbone_neck[5]["backbone"]
    cfg = dict(type="ResNet", depth=101, frozen_stages=frozen_stages)
    mults = joptim.build_lr_mult_tree(
        {"backbone": params},
        frozen_patterns=joptim.backbone_frozen_patterns(cfg,
                                                        prefix="backbone"))
    leaves = jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), m, np.float32), mults,
        {"backbone": params})
    # batch statistics are no parameters: ones, so none counts as frozen
    ones = jax.tree_util.tree_map(lambda x: np.ones(np.shape(x), np.float32),
                                  backbone_neck[6])
    want = {k for k, v in state_dict_from_jax(leaves, ones).items()
            if not bool(v.any())}
    holder = torch.nn.Module()
    holder.img_backbone = ResNet(depth=101)
    optimizer, _ = toptim.build_optimizer(
        holder, frozen_patterns=toptim.backbone_frozen_patterns(cfg))
    names = {id(p): n for n, p in holder.named_parameters()}
    got = {names[id(p)] for group in optimizer.param_groups
           if group["lr_mult"] == 0.0 for p in group["params"]}
    assert got == want
    stages = {int(k.split(".")[1][len("layer"):]) for k in got
              if ".layer" in k}
    assert stages == set(range(1, max(frozen_stages, 0) + 1))
    assert ("img_backbone.conv1.weight" in got) == (frozen_stages >= 0)


@pytest.fixture
def versions():
    """The reference ``.pth`` sets both packages' VERSION tag; restore it."""
    old = VERSION.name, JAX_VERSION.name
    yield
    VERSION.name, JAX_VERSION.name = old


def test_r101_reference_pth_loads_as_the_jax_porting(backbone_neck,
                                                     tmp_path, versions):
    params, stats = backbone_neck[5], backbone_neck[6]
    path = str(tmp_path / "r101.pth")
    _write_reference_pth(path, params, stats)
    want = _jax_load(path, "ResNet", params, stats)
    cfg = copy.deepcopy(MODEL)
    model = random_init_(build_detector({"model": cfg}, device="cpu"), 0)
    report = checkpoint_io.load_pretrained(
        model, checkpoint_io.load_torch_checkpoint(path),
        [("backbone", "img_backbone")])
    got = model.state_dict()
    assert sum(k.startswith("img_backbone.layer3.") and
               k.endswith(".conv2.weight") for k in want) == 23
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert report["unexpected"] == ["img_backbone.fc.weight"]
    assert all(k.startswith("pts_bbox_head.") for k in report["missing"])


# ---------------------------------------------------------- the stream --

B, T, N = 1, 2, 6
H, W = 64, 128
Q, P, L, LAYERS, G = 16, 2, 5, 2, 4
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="ResNet", depth=101, with_cp=True),
    img_neck=dict(type="FPN", in_channels=IN_CHANNELS, out_channels=C,
                  num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=10, in_channels=C, num_query=Q,
        num_frames=T, num_points=P, num_layers=LAYERS, num_levels=L,
        code_size=10, pc_range=PC, num_groups=G, mixer_out_points=32,
        table_gsplit=(False, False, True, False, False),
        table_gsplit_pack=(False, False, True, False, False)),
)
ATOL = 2e-3      # as tests/test_torch_streaming.py


@pytest.fixture(scope="module")
def r101_stream():
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (3, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)
    samples = [(frames[i], l2i, td,
                [f"/data/sweeps/f{j}_cam{v}.jpg" for j in (i, max(i - 1, 0))
                 for v in range(N)]) for i in range(3)]
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    img0 = jnp.asarray(np.concatenate([frames[0]] * T, axis=1))
    shapes = jax.eval_shape(
        lambda *a: jmodel.init({"params": jax.random.PRNGKey(0),
                                "aug": jax.random.PRNGKey(1)}, *a,
                               train=False),
        img0, jnp.asarray(l2i), jnp.asarray(td))
    variables = {"params": _noised(shapes["params"], rng),
                 "batch_stats": _noised(shapes["batch_stats"], rng)}
    tmodel = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    jdet = JaxStreaming(jmodel, variables, num_frames=T, cache_size=T)
    tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                             device="cpu")
    outs = [(jax.device_get(jdet.infer(*s)),
             {k: v.numpy() for k, v in tdet.infer(*s).items()})
            for s in samples]
    return jdet, tdet, outs


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_r101_stream_matches_jax(r101_stream, sample):
    _, _, outs = r101_stream
    jp, tp = outs[sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert tp[key].shape == jp[key].shape
        np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(tp["all_bbox_preds"], jp["all_bbox_preds"],
                               rtol=0, atol=ATOL)


def test_r101_stream_ring_has_five_levels(r101_stream):
    jdet, tdet, _ = r101_stream
    assert list(tdet.slot_of_key.items()) == list(jdet.slot_of_key.items())
    assert [tuple(t.shape) for t in tdet.ring] == [
        (T * N * h * G, w + 1, 2 * C // G)
        for h, w in [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]]
    assert tdet._meta.gsplit == (False, False, True, False, False)
