"""The port's EVA02 path against the JAX package: a small EVA02 SparseBEV
(embed 64, 4 heads, depth 3: block 0 windowed over a 4x8 token grid padded
to 6x9 by 3x3 windows, block 1 global, block 2 global with the residual
block; the pyramid at four scales and the top block, 64 channels; no neck;
``table_yfold=(False, True, True, True, True)``, ``table_gsplit`` on L3,
Q=16, T=3, P=2, 2 layers, 64x128 images, fp32), with the JAX weights carried
into the port by ``state_dict_from_jax``. Every param gets seeded noise
first (``test_torch_streaming.noise_tree``). The full forward
(``train=False``) over T frames, and streaming inference over 3 samples with
one new frame each."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import StreamingDetector as JaxStreaming
from sparsebev_tpu.inference import init_streaming_variables
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV

from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.ops import eva_attention
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)

from test_torch_streaming import PC, make_cameras, noise_tree

torch.set_num_threads(1)

B, T, N = 1, 3, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 5, 2
YFOLD = (False, True, True, True, True)
GSPLIT = (False, False, False, True, False)
NORM = dict(mean=[123.675, 116.280, 103.530], std=[58.395, 57.120, 57.375],
            to_rgb=True)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="EVA02", img_size=64, real_img_size=(H, W),
                      patch_size=16, embed_dim=64, depth=3, num_heads=4,
                      window_size=3, window_block_indexes=(0,),
                      residual_block_indexes=(2,), pretrain_img_size=32,
                      fpn_out_channels=C, fpn_top_block=True,
                      drop_path_rate=0.3, use_act_checkpoint=True,
                      frozen_blocks=1),
    img_neck=None,
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=10, in_channels=C, num_query=Q,
        num_frames=T, num_points=P, num_layers=LAYERS, num_levels=L,
        code_size=10, pc_range=PC, num_groups=G, mixer_out_points=32,
        table_yfold=YFOLD, table_gsplit=GSPLIT, table_gsplit_pack=GSPLIT),
)
# raw last-layer outputs, fp32 through the ViT, the pyramid and 2 decoder
# layers: the two frameworks round products and reductions differently (as
# in tests/test_torch_vov_streaming.py)
ATOL = 2e-3


def _stream(rng):
    """3 samples, one new frame each, T=3 (history padded with frame 0)."""
    frames = rng.randint(0, 256, (3, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5, 1.0]], np.float32)
    samples = []
    for i in range(3):
        ids = [max(i - j, 0) for j in range(T)]
        names = [f"/data/sweeps/f{j}_cam{v}.jpg" for j in ids
                 for v in range(N)]
        samples.append((frames[i], l2i, td, names))
    return frames, samples


@pytest.fixture(scope="module")
def both():
    rng = np.random.RandomState(0)
    frames, samples = _stream(rng)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    variables = init_streaming_variables(
        jmodel, jnp.asarray(samples[0][0]), jnp.asarray(samples[0][1]),
        jnp.asarray(samples[0][2]), H, W)
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": variables.get("batch_stats", {})}
    tmodel = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    return jmodel, variables, tmodel, frames, samples


@pytest.fixture(scope="module")
def streamed(both):
    jmodel, variables, tmodel, _, samples = both
    jdet = JaxStreaming(jmodel, variables, num_frames=T, cache_size=T)
    tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                             device="cpu")
    outs = []
    for s in samples:
        jp = jax.device_get(jdet.infer(*s))
        tp = {k: v.numpy() for k, v in tdet.infer(*s).items()}
        outs.append((jp, tp))
    return jdet, tdet, outs


def test_eva02_detector_forward_matches_jax(both):
    """The full forward over T frames of 6 views, ``train=False``."""
    jmodel, variables, tmodel, frames, samples = both
    img = np.concatenate([frames[2], frames[1], frames[0]], axis=0)
    img = img.reshape(1, T * N, H, W, 3)
    l2i, td = samples[2][1], samples[2][2]
    jp = jax.device_get(jmodel.apply(variables, jnp.asarray(img),
                                     jnp.asarray(l2i), jnp.asarray(td),
                                     train=False))
    with torch.no_grad():
        tp = tmodel(torch.from_numpy(img), torch.from_numpy(l2i),
                    torch.from_numpy(td))
    for key in ("all_cls_scores", "all_bbox_preds"):
        got = tp[key].numpy()
        assert got.shape == jp[key].shape
        np.testing.assert_allclose(got, jp[key], rtol=0, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_eva02_streaming_last_layer_matches_jax(streamed, sample):
    _, _, outs = streamed
    jp, tp = outs[sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert tp[key].shape == jp[key].shape
        assert np.isfinite(tp[key]).all()
        np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(tp["all_bbox_preds"], jp["all_bbox_preds"],
                               rtol=0, atol=ATOL)


def test_eva02_streaming_ring_and_frames(streamed):
    """One frame pass a new frame (the ring reuses the history), L0 in pair
    rows, L1-L4 in y-fold rows; the 3 attention calls of each frame pass go
    through the op (its plain version on the CPU, which counts no
    launches)."""
    jdet, tdet, _ = streamed
    assert list(tdet.slot_of_key.items()) == list(jdet.slot_of_key.items())
    assert tdet.frames_run == 3
    assert tdet._meta.yfold == YFOLD and tdet._meta.gsplit == GSPLIT
    shapes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    for lvl, (ring, (h, w)) in enumerate(zip(tdet.ring, shapes)):
        row = (2 if YFOLD[lvl] else 1) * C // G
        assert ring.shape == (T * N * h * G, w + 1, row)
    assert eva_attention.eva_attention.launches == 0


def test_eva02_weights_round_trip(both):
    """``jax_trees_from_state_dict`` inverts ``state_dict_from_jax`` on the
    EVA02 tree (every leaf, the pyramid's deconvs and the residual block
    included)."""
    _, variables, tmodel, _, _ = both
    tensors = dict(tmodel.state_dict())
    p_tree, _ = jax_trees_from_state_dict(tensors, variables["params"],
                                          variables["batch_stats"])
    want = jax.tree_util.tree_leaves(variables["params"])
    got = jax.tree_util.tree_leaves(p_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
