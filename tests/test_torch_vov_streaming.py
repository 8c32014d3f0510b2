"""The port's second path against the JAX package: streaming inference of a
small VoVNet SparseBEV (V-99-eSE at full width, FPN 64 ch with 5 outputs,
``table_yfold=(False, True, True, True, True)``, ``table_gsplit`` on L3,
Q=16, T=3, P=2, 2 layers, 64x128 images, fp32) over 3 samples, with the JAX
weights carried into the port by ``state_dict_from_jax``. Every param and
batch stat gets seeded noise first (``test_torch_streaming.noise_tree``)."""

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
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_streaming import PC, make_cameras, noise_tree

torch.set_num_threads(1)

B, T, N = 1, 3, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 5, 2
YFOLD = (False, True, True, True, True)
GSPLIT = (False, False, False, True, False)
NORM = dict(mean=[103.530, 116.280, 123.675], std=[57.375, 57.120, 58.395],
            to_rgb=False)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="VoVNet", spec_name="V-99-eSE",
                      out_features=["stage2", "stage3", "stage4", "stage5"],
                      norm_eval=True, frozen_stages=1, with_cp=True),
    img_neck=dict(type="FPN", in_channels=[256, 512, 768, 1024],
                  out_channels=C, num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=10, in_channels=C, num_query=Q,
        num_frames=T, num_points=P, num_layers=LAYERS, num_levels=L,
        code_size=10, pc_range=PC, num_groups=G, mixer_out_points=32,
        table_yfold=YFOLD, table_gsplit=GSPLIT, table_gsplit_pack=GSPLIT),
)
# raw last-layer outputs, fp32 through V-99 + FPN + 2 decoder layers: the
# two frameworks round convolutions and reductions differently
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
    return samples


@pytest.fixture(scope="module")
def both():
    rng = np.random.RandomState(0)
    samples = _stream(rng)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    variables = init_streaming_variables(
        jmodel, jnp.asarray(samples[0][0]), jnp.asarray(samples[0][1]),
        jnp.asarray(samples[0][2]), H, W)
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}

    tmodel = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    jdet = JaxStreaming(jmodel, variables, num_frames=T, cache_size=T)
    tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                             device="cpu")
    outs = []
    for s in samples:
        jp = jax.device_get(jdet.infer(*s))
        tp = {k: v.numpy() for k, v in tdet.infer(*s).items()}
        outs.append((jp, tp))
    return jdet, tdet, outs


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_vov_streaming_last_layer_matches_jax(both, sample):
    _, _, outs = both
    jp, tp = outs[sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert tp[key].shape == jp[key].shape
        assert np.isfinite(tp[key]).all()
        np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(tp["all_bbox_preds"], jp["all_bbox_preds"],
                               rtol=0, atol=ATOL)


def test_vov_streaming_ring_matches_jax(both):
    """The port's ring: one table per level, L0 in pair rows (Cg wide),
    L1-L4 in y-fold rows (2Cg), the head's group-split flags carried."""
    jdet, tdet, _ = both
    assert list(tdet.slot_of_key.items()) == list(jdet.slot_of_key.items())
    assert tdet._meta.yfold == YFOLD and tdet._meta.gsplit == GSPLIT
    shapes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    for lvl, (ring, (h, w)) in enumerate(zip(tdet.ring, shapes)):
        row = (2 if YFOLD[lvl] else 1) * C // G
        assert ring.shape == (T * N * h * G, w + 1, row)
    # the JAX ring holds L3 as per-group chunks of the same rows
    assert len(jdet.ring[3]) == G
