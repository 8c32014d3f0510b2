"""The port's remats change no bit: a DN-on training step of a small VoVNet
SparseBEV (V-19-slim-eSE, FPN 64 ch with 5 outputs, a pair-mode level 0 and
a group-split level 3, Q=16, T=2, P=2, 6 decoder layers, 64x128 images,
fp32) with dropout on, GridMask and colour augmentation on, every draw from
one seeded generator, gives the same loss and the same gradient bits with
each remat on and off: the decoder's layer remat, and the VoVNet's
``with_cp`` (every OSA module, each stage's pool inside its first block's
region). With the decoder remat the
sampling forward still runs once a layer (its output is kept, not
recomputed), and the packed tables' gradient, summed over the six layers'
sampling backwards, reaches the pack adjoints whole."""

import copy

import numpy as np
import pytest
import torch

from sparsebev_tpu_torch.models import layers as tlayers
from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.ops import msmv_pack
from sparsebev_tpu_torch.ops import msmv_sampling as ms
from sparsebev_tpu_torch.train.step import create_train_state, make_train_step

from test_torch_streaming import PC, make_cameras

torch.set_num_threads(1)

B, T, N = 1, 2, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 5, 6
MAX_GT, DN_GROUPS, NUM_CLASSES = 8, 2, 10
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
YFOLD = (False, True, True, True, True)
GSPLIT = (False, False, False, True, False)
NORM = dict(mean=[103.530, 116.280, 123.675], std=[57.375, 57.120, 58.395],
            to_rgb=False)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    use_grid_mask=True,
    data_aug=dict(img_color_aug=True, img_norm_cfg=NORM,
                  img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="VoVNet", spec_name="V-19-slim-eSE",
                      out_features=["stage2", "stage3", "stage4", "stage5"],
                      norm_eval=True, frozen_stages=1, with_cp=True),
    img_neck=dict(type="FPN", in_channels=[112, 256, 384, 512],
                  out_channels=C, num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=NUM_CLASSES, in_channels=C,
        num_query=Q, num_frames=T, num_points=P, num_layers=LAYERS,
        num_levels=L, code_size=10, pc_range=PC, num_groups=G,
        mixer_out_points=32, table_yfold=YFOLD, table_gsplit=GSPLIT,
        table_gsplit_pack=GSPLIT),
)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, T * N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4)
    gt_boxes = np.concatenate([
        rng.uniform(-30, 30, (B, MAX_GT, 2)),
        rng.uniform(-2, 1, (B, MAX_GT, 1)),
        rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
        rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
        rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
    gt_mask = np.zeros((B, MAX_GT), bool)
    gt_mask[:, :5] = True
    gt_boxes[~gt_mask] = 0.0
    return {k: torch.from_numpy(v) for k, v in dict(
        img=img, lidar2img=l2i, time_diff=np.asarray([[0.0, 0.5]], np.float32),
        gt_boxes=gt_boxes, gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)),
        gt_mask=gt_mask).items()}


def _step(decoder_cp=True, backbone_cp=True):
    """One step's metrics, every parameter's gradient and the generator's
    next draws after the step."""
    model = random_init_(build_detector({"model": copy.deepcopy(MODEL)},
                                        device="cpu"), 0)
    model.pts_bbox_head.transformer.decoder.with_cp = decoder_cp
    model.img_backbone.with_cp = backbone_cp
    grads = {}

    class Probe(torch.optim.SGD):
        def step(self):
            grads.update({k: p.grad.clone()
                          for k, p in model.named_parameters()})

    step = make_train_step(NUM_CLASSES, CW, PC, Q, dn_groups=DN_GROUPS)
    state = create_train_state(model, Probe(model.parameters(), lr=0.0))
    gen = torch.Generator().manual_seed(3)
    _, metrics = step(state, _batch(), generator=gen)
    return metrics, grads, torch.rand(4, generator=gen)


@pytest.fixture(scope="module")
def plain():
    return _step(decoder_cp=False, backbone_cp=False)


@pytest.mark.parametrize("decoder_cp,backbone_cp", [
    (True, False), (False, True), (True, True)],
    ids=["decoder", "vovnet", "both"])
def test_remat_changes_no_loss_or_gradient_bit(plain, decoder_cp,
                                               backbone_cp):
    want_m, want_g, want_next = plain
    got_m, got_g, got_next = _step(decoder_cp, backbone_cp)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    assert set(got_g) == set(want_g) and len(got_g) > 100
    for k in want_g:
        assert torch.equal(got_g[k], want_g[k]), k
    # the generator stands where the step without remat left it
    assert torch.equal(got_next, want_next)
    assert all(bool(torch.isfinite(v)) for v in got_m.values())


def test_dropout_draws_matter_here():
    """The remat test would not see a replay that drew other masks if the
    masks did not reach the loss: with another seed the loss moves."""
    model = random_init_(build_detector({"model": copy.deepcopy(MODEL)},
                                        device="cpu"), 0)
    losses = []
    for seed in (3, 3, 4):
        tlayers.set_dropout_generator(model,
                                      torch.Generator().manual_seed(seed))
        model.aug_generator = torch.Generator().manual_seed(0)
        b = _batch()
        with torch.no_grad():
            out = model(b["img"], b["lidar2img"], b["time_diff"], train=True)
        losses.append(out["all_cls_scores"].sum().item())
    assert losses[0] == losses[1] != losses[2]


def test_decoder_remat_samples_once_a_layer_and_sums_the_table_gradient(
        monkeypatch):
    """Under the decoder remat the sampling forward runs once a layer (6,
    not 12) and its backward once a call; the sampling calls hand autograd
    no table gradient (they add into the pack's ``TableGrad``), and each
    level's pack adjoint runs once on the gradient summed over the six
    calls, the same bits as without the remat."""
    calls = {"fwd": 0, "bwd": 0, "tables_to_autograd": 0}
    adjoint = {}
    fwd, bwd = ms.msmv_sampling_plain, ms.msmv_sampling_backward_plain
    real_backward = ms._MsmvSampling.backward

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    def backward(ctx, grad_out):
        out = real_backward(ctx, grad_out)
        calls["tables_to_autograd"] += sum(d is not None for d in out[3:])
        return out

    def record(name, plain_fn):
        def run(dt, g):
            adjoint.setdefault(name, []).append(dt.clone())
            return plain_fn(dt, g)
        return run

    monkeypatch.setattr(ms, "msmv_sampling_plain", count_fwd)
    monkeypatch.setattr(ms, "msmv_sampling_backward_plain", count_bwd)
    monkeypatch.setattr(ms._MsmvSampling, "backward", staticmethod(backward))
    monkeypatch.setattr(msmv_pack, "pack_level_bwd_plain",
                        record("yfold", msmv_pack.pack_level_bwd_plain))
    monkeypatch.setattr(msmv_pack, "pack_level_pair_bwd_plain",
                        record("pair", msmv_pack.pack_level_pair_bwd_plain))
    seen = {}
    for cp in (False, True):
        calls.update(fwd=0, bwd=0, tables_to_autograd=0)
        adjoint.clear()
        _step(decoder_cp=cp)
        assert calls == dict(fwd=LAYERS, bwd=LAYERS, tables_to_autograd=0), cp
        assert len(adjoint["pair"]) == 1 and len(adjoint["yfold"]) == L - 1
        seen[cp] = {k: list(v) for k, v in adjoint.items()}
    for kind in ("pair", "yfold"):
        for a, b in zip(seen[True][kind], seen[False][kind]):
            assert torch.equal(a, b)
            assert bool(a.abs().sum() > 0)
