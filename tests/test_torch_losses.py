"""The port's training-side functions against the JAX package on the CPU,
on inputs made from a seed with numpy: box codecs, focal / L1 losses and
costs, the matcher, the detection and denoising losses (values and
gradients), ``prepare_dn_inputs`` and the two augmentations with the JAX
draws injected, and the learning-rate schedule."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.bbox import match_costs as jcosts
from sparsebev_tpu.losses import denoising as jdn
from sparsebev_tpu.losses import focal as jfocal
from sparsebev_tpu.losses import matching as jmatching
from sparsebev_tpu.losses import target as jtarget
from sparsebev_tpu.losses.l1 import l1_loss as jl1
from sparsebev_tpu.models import augment as jaug
from sparsebev_tpu.ops import box_ops as jbox
from sparsebev_tpu.train.optim import cosine_warmup_schedule as jschedule

from sparsebev_tpu_torch.bbox import match_costs as tcosts
from sparsebev_tpu_torch.losses import denoising as tdn
from sparsebev_tpu_torch.losses import focal as tfocal
from sparsebev_tpu_torch.losses import matching as tmatching
from sparsebev_tpu_torch.losses import target as ttarget
from sparsebev_tpu_torch.losses.l1 import l1_loss as tl1
from sparsebev_tpu_torch.models import augment as taug
from sparsebev_tpu_torch.ops import box_ops as tbox
from sparsebev_tpu_torch.train.optim import cosine_warmup_schedule as tschedule

torch.set_num_threads(1)

PC = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
NUM_CLASSES = 10
# fp32 elementwise math in both frameworks (exp / log / sigmoid differ in
# the last ulp; sums in another order)
RTOL, ATOL = 2e-5, 2e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _world_boxes(rng, *lead):
    return np.concatenate([
        rng.uniform(-45, 45, lead + (2,)), rng.uniform(-4, 2, lead + (1,)),
        rng.uniform(0.5, 6.0, lead + (3,)),
        rng.uniform(-np.pi, np.pi, lead + (1,)),
        rng.uniform(-3, 3, lead + (2,))], -1).astype(np.float32)


def _batch(rng, b=3, m=6, q=20, layers=2):
    """Predictions and padded ground truth; sample 1 has no valid box."""
    gt_boxes = _world_boxes(rng, b, m)
    gt_labels = rng.randint(0, NUM_CLASSES, (b, m)).astype(np.int32)
    gt_mask = rng.rand(b, m) < 0.7
    gt_mask[0, :2] = True
    gt_mask[1] = False
    gt_boxes[~gt_mask] = 0.0        # padded rows: zeros (log(0) if not safe)
    cls = (rng.randn(layers, b, q, NUM_CLASSES) * 2).astype(np.float32)
    box = jbox.normalize_bbox(jnp.asarray(_world_boxes(rng, layers, b, q)))
    return np.asarray(cls), np.asarray(box), gt_boxes, gt_labels, gt_mask


# ------------------------------------------------------------- box codecs --

def test_box_codecs_match_jax():
    rng = np.random.RandomState(0)
    boxes = _world_boxes(rng, 4, 7)
    _close(tbox.normalize_bbox(_t(boxes)), jbox.normalize_bbox(boxes))
    _close(tbox.encode_bbox(_t(boxes), PC), jbox.encode_bbox(boxes, PC))
    _close(tbox.encode_bbox(_t(boxes[..., :7])),
           jbox.encode_bbox(boxes[..., :7]))
    enc = tbox.encode_bbox(_t(boxes), PC)
    _close(tbox.decode_bbox(enc, PC), boxes, rtol=1e-4, atol=1e-4)
    norm = tbox.normalize_bbox(_t(boxes))
    _close(tbox.denormalize_bbox(norm), boxes, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ losses and costs --

def test_focal_loss_matches_jax_with_gradient():
    rng = np.random.RandomState(1)
    logits = (rng.randn(50, NUM_CLASSES) * 3).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES + 1, 50).astype(np.int32)  # with bg
    weights = rng.rand(50).astype(np.float32)
    fn = lambda lg: jfocal.focal_loss(lg, labels, weights, 7.0, NUM_CLASSES)
    want, want_grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    got = tfocal.focal_loss(tl, _t(labels), _t(weights), 7.0, NUM_CLASSES)
    got.backward()
    _close(got, want)
    _close(tl.grad, want_grad)
    # a zero normalizer is clamped, not divided by
    tiny = tfocal.focal_loss(_t(logits), _t(labels), _t(weights), 0.0,
                             NUM_CLASSES)
    _close(tiny, jfocal.focal_loss(logits, labels, weights, 0.0,
                                   NUM_CLASSES), rtol=1e-4)


def test_l1_loss_matches_jax_with_gradient():
    rng = np.random.RandomState(2)
    pred, tgt = rng.randn(2, 30, 10).astype(np.float32)
    w = rng.rand(30, 10).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda p: jl1(p, tgt, w, 5.0))(jnp.asarray(pred))
    tp = _t(pred).requires_grad_()
    got = tl1(tp, _t(tgt), _t(w), 5.0)
    got.backward()
    _close(got, want)
    _close(tp.grad, want_grad)


def test_match_costs_match_jax():
    rng = np.random.RandomState(3)
    logits = (rng.randn(20, NUM_CLASSES) * 2).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, 6).astype(np.int32)
    _close(tfocal.focal_loss_cost(_t(logits), _t(labels)),
           jfocal.focal_loss_cost(logits, labels))
    # batched over a leading (layer) dim, as the detection loss calls it
    stacked = np.stack([logits, logits[::-1]])
    got = tfocal.focal_loss_cost(_t(stacked.copy()), _t(labels))
    _close(got[1], jfocal.focal_loss_cost(stacked[1], labels))
    pred, gt = rng.randn(20, 10).astype(np.float32), \
        rng.randn(6, 10).astype(np.float32)
    _close(tcosts.bbox3d_l1_cost(_t(pred), _t(gt), 0.25),
           jcosts.bbox3d_l1_cost(pred, gt, 0.25))
    _close(tcosts.bbox_bev_l1_cost(_t(pred), _t(gt), PC, 2.0),
           jcosts.bbox_bev_l1_cost(pred, gt, PC, 2.0))
    iou = rng.rand(20, 6).astype(np.float32)
    _close(tcosts.iou3d_cost(_t(iou), 0.5), jcosts.iou3d_cost(iou, 0.5))


# ---------------------------------------------------------------- matcher --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_equals_jax_hungarian(seed):
    """Costs with a seeded continuous perturbation (no ties), leading
    (layer, batch) dims, a sample without ground truth and a fully padded
    one, NaN / inf entries: the assignment of every valid row equals the
    JAX package's on-device Hungarian."""
    rng = np.random.RandomState(seed)
    layers, b, m, q = 2, 4, 7, 19
    cost = (rng.randint(0, 4, (layers, b, m, q))
            + rng.uniform(0, 1e-2, (layers, b, m, q))).astype(np.float32)
    cost[0, 0, 1, 3] = np.nan
    cost[1, 2, 0, 5] = np.inf
    cost[1, 2, 4, 2] = -np.inf
    mask = rng.rand(b, m) < 0.6
    mask[0] = True
    mask[1] = False                       # no ground truth
    mask[3] = False                       # fully padded as well
    want = np.asarray(jmatching.hungarian_matching(
        jnp.asarray(cost), jnp.broadcast_to(jnp.asarray(mask),
                                            (layers, b, m))))
    got = tmatching.hungarian_matching(_t(cost), _t(mask))
    assert got.dtype == torch.int64 and tuple(got.shape) == (layers, b, m)
    full = np.broadcast_to(mask, (layers, b, m))
    np.testing.assert_array_equal(got.numpy()[full], want[full])
    # an assignment: no query taken twice among a sample's valid rows
    for l in range(layers):
        for i in range(b):
            cols = got.numpy()[l, i][mask[i]]
            assert len(set(cols.tolist())) == len(cols)


def test_matcher_square_and_single_row():
    rng = np.random.RandomState(5)
    cost = rng.rand(5, 5).astype(np.float32)
    mask = np.ones(5, bool)
    want = np.asarray(jmatching.hungarian_matching(jnp.asarray(cost),
                                                   jnp.asarray(mask)))
    np.testing.assert_array_equal(
        tmatching.hungarian_matching(_t(cost), _t(mask)).numpy(), want)
    one = rng.rand(1, 9).astype(np.float32)
    got = tmatching.hungarian_matching(_t(one), _t(np.ones(1, bool)))
    assert int(got[0]) == int(one.argmin())


# ------------------------------------------------------- detection losses --

def test_detection_loss_matches_jax_with_gradients():
    rng = np.random.RandomState(7)
    cls, box, gt_boxes, gt_labels, gt_mask = _batch(rng)

    def jloss(c, bx):
        d = jtarget.compute_detection_loss(c, bx, gt_boxes, gt_labels,
                                           gt_mask, NUM_CLASSES, CW)
        return sum(d.values()), d

    (_, want), (gc, gb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(cls), jnp.asarray(box))
    tc, tb = _t(cls).requires_grad_(), _t(box).requires_grad_()
    got = ttarget.compute_detection_loss(
        tc, tb, _t(gt_boxes), _t(gt_labels), _t(gt_mask), NUM_CLASSES, CW)
    # (the aux dict comes back from jax.value_and_grad with sorted keys)
    assert list(got) == ["loss_cls", "loss_bbox", "d0.loss_cls",
                         "d0.loss_bbox"]
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-4)
    sum(got.values()).backward()
    _close(tc.grad, gc, rtol=1e-4, atol=1e-6)
    _close(tb.grad, gb, rtol=1e-4, atol=1e-6)


def test_detection_loss_without_any_ground_truth():
    rng = np.random.RandomState(8)
    cls, box, gt_boxes, gt_labels, gt_mask = _batch(rng, b=2)
    gt_mask[:] = False
    gt_boxes[:] = 0.0
    want = jtarget.compute_detection_loss(cls, box, gt_boxes, gt_labels,
                                          gt_mask, NUM_CLASSES, CW)
    got = ttarget.compute_detection_loss(
        _t(cls), _t(box), _t(gt_boxes), _t(gt_labels), _t(gt_mask),
        NUM_CLASSES, CW)
    for k in want:
        assert bool(torch.isfinite(got[k]))
        _close(got[k], want[k], rtol=1e-4)
    assert float(got["loss_bbox"]) == 0.0


def test_matching_cost_takes_one_transfer_for_all_layers(monkeypatch):
    rng = np.random.RandomState(9)
    cls, box, gt_boxes, gt_labels, gt_mask = _batch(rng, layers=3)
    calls = []
    real = tmatching.hungarian_matching
    monkeypatch.setattr(ttarget, "hungarian_matching",
                        lambda c, m: calls.append(tuple(c.shape)) or real(c, m))
    ttarget.compute_detection_loss(_t(cls), _t(box), _t(gt_boxes),
                                   _t(gt_labels), _t(gt_mask), NUM_CLASSES,
                                   CW)
    assert calls == [(3, 3, 6, 20)]


# --------------------------------------------------------------- denoising --

def test_dn_attn_mask_equals_jax():
    np.testing.assert_array_equal(tdn.build_dn_attn_mask(16, 8, 3),
                                  jdn.build_dn_attn_mask(16, 8, 3))


def _jax_dn_draws(key, b, g, m):
    """The draws ``prepare_dn_inputs`` makes from ``key`` in the JAX package."""
    k_box, k_label_p, k_label_v = jax.random.split(key, 3)
    return dict(
        box=np.asarray(jax.random.uniform(k_box, (b, g, m, 3), minval=-1.0,
                                          maxval=1.0)),
        flip=np.asarray(jax.random.uniform(k_label_p, (b, g, m))),
        label=np.asarray(jax.random.randint(k_label_v, (b, g, m), 0,
                                            NUM_CLASSES)))


def test_prepare_dn_inputs_matches_jax_with_injected_draws():
    rng = np.random.RandomState(10)
    _, _, gt_boxes, gt_labels, gt_mask = _batch(rng, b=3, m=6)
    key = jax.random.PRNGKey(4)
    g, q = 4, 16
    want = jdn.prepare_dn_inputs(key, jnp.asarray(gt_boxes),
                                 jnp.asarray(gt_labels), jnp.asarray(gt_mask),
                                 num_query=q, num_classes=NUM_CLASSES,
                                 pc_range=PC, groups=g)
    noise = {k: _t(v) for k, v in _jax_dn_draws(key, 3, g, 6).items()}
    got = tdn.prepare_dn_inputs(noise, _t(gt_boxes), _t(gt_labels),
                                _t(gt_mask), num_query=q,
                                num_classes=NUM_CLASSES, pc_range=PC,
                                groups=g)
    assert set(got) == set(want)
    _close(got["dn_query_bbox"], want["dn_query_bbox"], atol=1e-6)
    for k in ("dn_labels", "dn_mask", "attn_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert bool((np.asarray(want["dn_labels"])[~np.asarray(want["dn_mask"])]
                 == NUM_CLASSES).all())


def test_draw_dn_noise_ranges_and_reproducibility():
    gen = torch.Generator().manual_seed(3)
    a = tdn.draw_dn_noise(gen, 2, 3, 5, NUM_CLASSES, "cpu")
    b = tdn.draw_dn_noise(torch.Generator().manual_seed(3), 2, 3, 5,
                          NUM_CLASSES, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["box"].shape == (2, 3, 5, 3)
    assert float(a["box"].min()) >= -1 and float(a["box"].max()) < 1
    assert int(a["label"].min()) >= 0 and int(a["label"].max()) < NUM_CLASSES
    assert float(a["flip"].min()) >= 0 and float(a["flip"].max()) < 1


def test_dn_loss_matches_jax_with_gradients():
    rng = np.random.RandomState(11)
    g = 3
    _, _, gt_boxes, gt_labels, gt_mask = _batch(rng, b=3, m=6)
    cls = (rng.randn(2, 3, g * 6, NUM_CLASSES) * 2).astype(np.float32)
    box = np.asarray(jbox.normalize_bbox(
        jnp.asarray(_world_boxes(rng, 2, 3, g * 6))))

    def jloss(c, bx):
        d = jdn.compute_dn_loss(c, bx, gt_boxes, gt_labels, gt_mask,
                                NUM_CLASSES, CW, groups=g)
        return sum(d.values()), d

    (_, want), (gc, gb) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(cls), jnp.asarray(box))
    tc, tb = _t(cls).requires_grad_(), _t(box).requires_grad_()
    got = tdn.compute_dn_loss(tc, tb, _t(gt_boxes), _t(gt_labels),
                              _t(gt_mask), NUM_CLASSES, CW, groups=g)
    assert list(got) == ["loss_cls_dn", "loss_bbox_dn", "d0.loss_cls_dn",
                         "d0.loss_bbox_dn"]
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-4)
    sum(got.values()).backward()
    _close(tc.grad, gc, rtol=1e-4, atol=1e-6)
    _close(tb.grad, gb, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------- augmentations --

def _jax_grid_draws(key, h):
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    d = jax.random.randint(k_d, (), 2, h)
    return dict(u=float(jax.random.uniform(k_apply)), d=int(d),
                st_h=int(jax.random.randint(k_sh, (), 0, d)),
                st_w=int(jax.random.randint(k_sw, (), 0, d)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5])
def test_grid_mask_matches_jax_with_injected_draws(seed):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(3, 24, 40, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.grid_mask(key, jnp.asarray(imgs)))
    draws = _jax_grid_draws(key, 24)
    got = taug.grid_mask(_t(imgs), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (draws["u"] < 0.7) == bool((want != imgs).any())


def test_grid_mask_draws_from_a_generator():
    imgs = torch.rand(2, 16, 20, 3)
    seen = set()
    for seed in range(12):
        gen = torch.Generator().manual_seed(seed)
        d = taug.draw_grid_mask(gen, 16, "cpu")
        assert 2 <= int(d["d"]) < 16 and 0 <= int(d["st_h"]) < int(d["d"])
        assert 0 <= int(d["st_w"]) < int(d["d"])
        out = taug.grid_mask(imgs, d)
        seen.add(bool(torch.equal(out, imgs)))
        assert bool(((out == imgs) | (out == 0)).all())
    assert seen == {True, False}        # applied with probability 0.7


def _jax_photo_draws(key, n):
    keys = jax.random.split(key, 10)
    u = lambda k, lo, hi: np.asarray(jax.random.uniform(  # noqa: E731
        k, (n, 1, 1, 1), minval=lo, maxval=hi)).reshape(n)
    gate = lambda k: np.asarray(jax.random.bernoulli(  # noqa: E731
        k, 0.5, (n, 1, 1, 1))).reshape(n)
    k_swap, k_do = jax.random.split(keys[9])
    return dict(
        contrast_mode=gate(keys[0]), delta=u(keys[1], -32.0, 32.0),
        do_brightness=gate(keys[2]), alpha=u(keys[3], 0.5, 1.5),
        do_contrast=gate(keys[4]), saturation=u(keys[5], 0.5, 1.5),
        do_saturation=gate(keys[6]), hue=u(keys[7], -18.0, 18.0),
        do_hue=gate(keys[8]),
        perm_idx=np.asarray(jax.random.randint(k_swap, (n,), 0, 6)),
        do_swap=np.asarray(jax.random.bernoulli(k_do, 0.5, (n,))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_photometric_distortion_matches_jax_with_injected_draws(seed):
    rng = np.random.RandomState(seed)
    n = 8
    imgs = rng.randint(0, 256, (n, 12, 16, 3)).astype(np.float32)
    imgs[0, :3] = 128.0                 # gray pixels: zero chroma
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.photometric_distortion(key, jnp.asarray(imgs)))
    got = taug.photometric_distortion(_t(imgs), _jax_photo_draws(key, n))
    # fp32 hue arithmetic on values up to 255 * 1.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-3)
    assert np.abs(want - imgs).max() > 1.0


def test_hsv_round_trip_matches_jax():
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.float32)
    hsv = taug.rgb_to_hsv(_t(img))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug.rgb_to_hsv(img)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(taug.hsv_to_rgb(hsv).numpy(),
                               np.asarray(jaug.hsv_to_rgb(hsv.numpy())),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(taug.hsv_to_rgb(hsv).numpy(), img, atol=2e-2)


def test_photometric_draws_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_photometric(gen, 64, "cpu")
    assert set(d) == set(_jax_photo_draws(jax.random.PRNGKey(0), 2))
    assert all(v.shape == (64,) for v in d.values())
    assert 0.2 < float(d["do_hue"].float().mean()) < 0.8
    assert float(d["delta"].abs().max()) <= 32.0
    imgs = torch.randint(0, 256, (64, 4, 4, 3)).float()
    out = taug.photometric_distortion(imgs, d)
    assert out.shape == imgs.shape and bool(torch.isfinite(out).all())


# ----------------------------------------------------------------- schedule --

def test_cosine_warmup_schedule_matches_jax():
    js = jschedule(2e-4, 1000, warmup_iters=50)
    ts = tschedule(2e-4, 1000, warmup_iters=50)
    for step in (0, 1, 25, 49, 50, 51, 500, 999, 1000, 1500):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5)
