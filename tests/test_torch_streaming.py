"""The port's whole slice against the JAX package: streaming inference of a
small SparseBEV (ResNet-50, FPN 64 ch, Q=16, T=2, P=2, 2 layers, 32x64
images, fp32, group-split L1 ring) over 3 samples, with the JAX weights
carried into the port by ``state_dict_from_jax``.

Every param and batch_stat leaf is overwritten with seeded noise first: the
JAX init leaves the sampling offsets, tau and the mixing generator at zero
and the BN statistics trivial, which would hide faults in those paths.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.bbox.nms_free_coder import NMSFreeCoder as JaxCoder
from sparsebev_tpu.inference import StreamingDetector as JaxStreaming
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV

from sparsebev_tpu_torch.bbox.nms_free_coder import NMSFreeCoder, build_coder
from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, N = 1, 2, 6
H, W = 32, 64
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 4, 2
PC = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="ResNet", depth=50),
    img_neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=C, num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=10, in_channels=C, num_query=Q,
        num_frames=T, num_points=P, num_layers=LAYERS, num_levels=L,
        code_size=10, pc_range=PC, num_groups=G, mixer_out_points=32,
        table_gsplit=(False, True, False, False),
        table_gsplit_pack=(False, True, False, False),
        bbox_coder=dict(type="NMSFreeCoder", pc_range=PC, max_num=Q * 10,
                        num_classes=10)),
)
# raw last-layer outputs, fp32 through ResNet-50 + FPN + 2 decoder layers:
# the two frameworks round convolutions and reductions differently
ATOL = 2e-3


def make_cameras(rng, image_h, image_w, n=N):
    """Six outward-facing pinhole cameras near the origin (lidar2img)."""
    mats = []
    for i in range(n):
        yaw = 2 * np.pi * i / n + rng.uniform(-0.1, 0.1)
        cy, sy = np.cos(yaw), np.sin(yaw)
        r_wc = np.array([[-sy, cy, 0.0], [0.0, 0.0, -1.0], [cy, sy, 0.0]])
        t = rng.uniform(-0.5, 0.5, 3)
        rt = np.eye(4)
        rt[:3, :3] = r_wc
        rt[:3, 3] = -r_wc @ t
        k = np.eye(4)
        f = image_w * 0.8
        k[0, 0], k[1, 1] = f, f
        k[0, 2], k[1, 2] = image_w / 2, image_h / 2
        mats.append((k @ rt).astype(np.float32))
    return np.stack(mats)


def noise_tree(tree, rng):
    """Seeded noise on every leaf, scaled by the leaf's role."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x)
        shape = x.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "in_proj_weight":
            v = rng.randn(*shape) / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "embedding":
            v = rng.randn(*shape)
        elif name == "init_query_bbox":
            v = x + 0.1 * rng.randn(*shape)
        else:  # biases, BN means
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_model_and_coder():
    """The JAX detector and coder of ``MODEL`` (fp32)."""
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    coder_cfg = cfg["pts_bbox_head"].pop("bbox_coder")
    coder_cfg.pop("type")
    return (JaxSparseBEV(compute_dtype=jnp.float32, **cfg),
            JaxCoder(**coder_cfg))


def _stream(rng):
    """3 samples, one new frame each, T=2 (sample 0 repeats frame 0)."""
    frames = rng.randint(0, 256, (3, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)
    samples = []
    for i in range(3):
        ids = [i, max(i - 1, 0)]
        names = [f"/data/sweeps/f{j}_cam{v}.jpg" for j in ids
                 for v in range(N)]
        samples.append((frames[i], l2i, td, names))
    return frames, samples


@pytest.fixture(scope="module")
def both():
    rng = np.random.RandomState(0)
    frames, samples = _stream(rng)
    jmodel, jcoder = jax_model_and_coder()
    img0 = jnp.asarray(np.concatenate([frames[0]] * T, axis=1))
    init = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))
    variables = init(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        img0, jnp.asarray(samples[0][1]), jnp.asarray(samples[0][2]))
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}

    tmodel = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    # a ring of T slots: sample 2 evicts frame 0 (FIFO) while its own
    # frames stay protected
    jdet = JaxStreaming(jmodel, variables, num_frames=T, cache_size=T)
    tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                             device="cpu")
    outs = []
    for s in samples:
        jp = jax.device_get(jdet.infer(*s))
        tp = {k: v.numpy() for k, v in tdet.infer(*s).items()}
        outs.append((jp, tp))
    return jdet, tdet, jcoder, outs, samples


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_streaming_last_layer_matches_jax(both, sample):
    _, _, _, outs, _ = both
    jp, tp = outs[sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert tp[key].shape == jp[key].shape
        np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)
    # the skipped cls slots of the first L-1 layers
    np.testing.assert_array_equal(tp["all_cls_scores"][:-1], -1e4)
    np.testing.assert_allclose(tp["all_bbox_preds"], jp["all_bbox_preds"],
                               rtol=0, atol=ATOL)


def test_streaming_ring_slots_match_jax(both):
    jdet, tdet, _, _, _ = both
    assert list(tdet.slot_of_key.items()) == list(jdet.slot_of_key.items())
    assert sorted(tdet.slot_of_key.values()) == [0, 1]   # frame 0 evicted
    assert len(tdet.ring) == L
    assert tdet.ring[0].shape == (T * N * 8 * G, 17, 2 * C // G)


def test_streaming_prefetch_upload_gives_same_outputs(both):
    _, tdet, _, outs, samples = both
    det = StreamingDetector(tdet.model, num_frames=T, cache_size=T,
                            device="cpu")
    for i, s in enumerate(samples):
        if i + 1 < len(samples):
            det.prefetch_upload(samples[i + 1][0], samples[i + 1][3])
        got = det.infer(*s)
        for key, want in outs[i][1].items():
            np.testing.assert_array_equal(got[key].numpy(), want)
    assert not det._pending


def test_streaming_decoded_boxes_match_jax(both):
    _, _, jcoder, outs, _ = both
    tcoder = build_coder({"model": MODEL})
    for jp, tp in outs:
        jd = jax.device_get(jcoder.decode(jp))
        td = tcoder.decode({k: torch.from_numpy(v) for k, v in tp.items()})
        js, ts = jd["scores"][0], td["scores"][0].numpy()
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-3)
        # compare labels/boxes only where the top-k order is not a near-tie
        gap = np.minimum(np.abs(np.diff(js, prepend=np.inf)),
                         np.abs(np.diff(js, append=-np.inf)))
        untied = gap > 1e-3
        assert untied.sum() >= 10
        np.testing.assert_array_equal(td["labels"][0].numpy()[untied],
                                      jd["labels"][0][untied])
        np.testing.assert_allclose(td["bboxes"][0].numpy()[untied],
                                   jd["bboxes"][0][untied], rtol=1e-3,
                                   atol=ATOL)


def test_flagship_config_parses_like_jax():
    from sparsebev_tpu.config import Config as JaxConfig
    path = os.path.join(REPO, "configs", "r50_nuimg_704x256.py")
    ours, ref = Config.fromfile(path), JaxConfig.fromfile(path)
    assert ours.to_dict() == ref.to_dict()
    ours.merge_from_dict({"model.pts_bbox_head.num_query": "400"})
    ref.merge_from_dict({"model.pts_bbox_head.num_query": "400"})
    assert ours.to_dict() == ref.to_dict()


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detector({"model": copy.deepcopy(MODEL)})


@pytest.mark.parametrize("override", [
    # fp8 rings are ported (tests/test_torch_fp8_ring.py); beside a split
    # ring the split still raises
    {"table_split": 2, "table_fp8": True},
    {"table_split": 2},
    {"table_split": (1, 1, 4, 1), "table_fp8": (True, False, False, False)},
])
def test_unported_table_modes_raise(override):
    cfg = copy.deepcopy(MODEL)
    cfg["pts_bbox_head"].update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_detector({"model": cfg}, device="cpu")


def test_coder_matches_jax_with_thresholds_and_version_swap():
    from sparsebev_tpu.utils.version import VERSION as JV
    from sparsebev_tpu_torch.utils.version import VERSION as TV
    rng = np.random.RandomState(3)
    cls = rng.randn(1, 1, 40, 10).astype(np.float32) * 3
    box = rng.randn(1, 1, 40, 10).astype(np.float32) * 30
    kw = dict(pc_range=PC, post_center_range=[-61.2, -61.2, -10.0, 61.2,
                                              61.2, 10.0],
              max_num=50, score_threshold=0.3, num_classes=10)
    for version in ("v1.0.0", "v0.17.1"):
        JV.name = TV.name = version
        try:
            jd = jax.device_get(JaxCoder(**kw).decode(
                {"all_cls_scores": cls, "all_bbox_preds": box}))
            td = NMSFreeCoder(**kw).decode(
                {"all_cls_scores": torch.from_numpy(cls),
                 "all_bbox_preds": torch.from_numpy(box)})
        finally:
            JV.name = TV.name = "v1.0.0"
        np.testing.assert_allclose(td["scores"].numpy(), jd["scores"],
                                   atol=1e-6)
        np.testing.assert_array_equal(td["labels"].numpy(), jd["labels"])
        np.testing.assert_array_equal(td["mask"].numpy(), jd["mask"])
        np.testing.assert_allclose(td["bboxes"].numpy(), jd["bboxes"],
                                   rtol=1e-5, atol=1e-4)
