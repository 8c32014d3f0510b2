"""One DN-on training step of a small VoVNet SparseBEV in the port against
the JAX train step on the CPU: V-19-slim-eSE (the smallest non-depthwise
spec) with ``with_cp`` on in both packages, FPN 64 ch with 5 outputs, a
pair-mode level 0 and a group-split pack on level 3 (the 1600x640 config's
table modes), Q=16, T=2, P=2, 2 decoder layers (the JAX layer remat on in
training, and the port's), 2 denoising groups of 8 ground-truth slots,
64x128 images, fp32. The JAX weights are carried into the port by
``state_dict_from_jax`` after every leaf was overwritten with seeded noise;
the denoising draws JAX makes from its key are injected into the port's
step, and dropout is off on both sides (see ``test_torch_train_step.py``).
The loss dict and every parameter gradient are held to the JAX step's at
that file's tolerances.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from sparsebev_tpu.losses import (compute_detection_loss as j_det_loss,
                                  compute_dn_loss as j_dn_loss,
                                  prepare_dn_inputs as j_prepare_dn)
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.train.step import (create_train_state as j_create_state,
                                      make_train_step as j_make_train_step)
from sparsebev_tpu.train import optim as joptim

from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.ops import msmv_pack
from sparsebev_tpu_torch.train import step as tstep
from sparsebev_tpu_torch.train.step import create_train_state, make_train_step
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)

from test_torch_streaming import PC, make_cameras, noise_tree
from test_torch_train_step import (GRAD_RTOL, _flat, _jax_dn_draws,
                                   _no_dropout)

torch.set_num_threads(1)

B, T, N = 1, 2, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 5, 2
MAX_GT, DN_GROUPS, NUM_CLASSES = 8, 2, 10
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
YFOLD = (False, True, True, True, True)
GSPLIT = (False, False, False, True, False)
NORM = dict(mean=[103.530, 116.280, 123.675], std=[57.375, 57.120, 58.395],
            to_rgb=False)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    use_grid_mask=False,
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
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
# the loss dict: test_torch_train_step.py's tolerance
LOSS_RTOL = 2e-3


def _batch(rng):
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4).astype(np.float32)
    gt_boxes = np.concatenate([
        rng.uniform(-30, 30, (B, MAX_GT, 2)),
        rng.uniform(-2, 1, (B, MAX_GT, 1)),
        rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
        rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
        rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
    gt_mask = np.zeros((B, MAX_GT), bool)
    gt_mask[:, :5] = True
    gt_boxes[~gt_mask] = 0.0
    return dict(
        img=rng.randint(0, 256, (B, T * N, H, W, 3)).astype(np.float32),
        lidar2img=l2i, time_diff=np.asarray([[0.0, 0.5]], np.float32),
        gt_boxes=gt_boxes,
        gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)).astype(np.int32),
        gt_mask=gt_mask)


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0)}, jb["img"], jb["lidar2img"],
        jb["time_diff"])
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    key = jax.random.PRNGKey(7)
    rng_dn, rng_aug, rng_drop = jax.random.split(key, 3)
    gt = (jb["gt_boxes"], jb["gt_labels"], jb["gt_mask"])
    real_dropout = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
    try:
        def loss_fn(params):
            dn = j_prepare_dn(rng_dn, *gt, num_query=Q,
                              num_classes=NUM_CLASSES, pc_range=PC,
                              groups=DN_GROUPS)
            preds = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb["img"], jb["lidar2img"], jb["time_diff"], dn_inputs=dn,
                train=True, rngs={"aug": rng_aug, "dropout": rng_drop})
            losses = j_det_loss(preds["all_cls_scores"],
                                preds["all_bbox_preds"], *gt, NUM_CLASSES, CW)
            losses.update(j_dn_loss(preds["dn_cls_scores"],
                                    preds["dn_bbox_preds"], *gt, NUM_CLASSES,
                                    CW, groups=DN_GROUPS))
            return sum(losses.values()), losses

        (_, j_losses), j_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        # and the real JAX train step (its optimizer is irrelevant here)
        tx, _ = joptim.build_optimizer(variables["params"], total_steps=10)
        _, j_metrics = jax.jit(j_make_train_step(
            jmodel, NUM_CLASSES, CW, PC, Q, query_denoising=True,
            dn_groups=DN_GROUPS))(j_create_state(variables, tx), jb, key)
    finally:
        fnn.Dropout.__call__ = real_dropout

    model = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    _no_dropout(model)
    # the gradients of the step, read before the clip scales them
    grads = {}
    real_clip = tstep.clip_by_global_norm

    def clip_and_record(params, max_norm):
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
        return real_clip(params, max_norm)

    adjoints = {"pair": 0, "yfold": 0}
    real = (msmv_pack.pack_level_pair_bwd_plain,
            msmv_pack.pack_level_bwd_plain)

    def count(kind, fn):
        def run(*a):
            adjoints[kind] += 1
            return fn(*a)
        return run

    msmv_pack.pack_level_pair_bwd_plain = count("pair", real[0])
    msmv_pack.pack_level_bwd_plain = count("yfold", real[1])
    tstep.clip_by_global_norm = clip_and_record
    try:
        step = make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=True,
                               dn_groups=DN_GROUPS)
        _, t_metrics = step(
            create_train_state(model, torch.optim.SGD(model.parameters(),
                                                      lr=0.0)),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            generator=torch.Generator().manual_seed(0),
            draws=dict(dn=_jax_dn_draws(rng_dn, B, DN_GROUPS, MAX_GT)))
    finally:
        (msmv_pack.pack_level_pair_bwd_plain,
         msmv_pack.pack_level_bwd_plain) = real
        tstep.clip_by_global_norm = real_clip
    return dict(variables=variables, j_losses=jax.device_get(j_losses),
                j_grads=jax.device_get(j_grads),
                j_metrics=jax.device_get(j_metrics),
                t_metrics={k: float(v) for k, v in t_metrics.items()},
                t_grads=grads, adjoints=adjoints)


def test_vov_training_loss_dict_matches_jax(world):
    want, got = world["j_losses"], world["t_metrics"]
    keys = {"loss_cls", "loss_bbox", "d0.loss_cls", "d0.loss_bbox",
            "loss_cls_dn", "loss_bbox_dn", "d0.loss_cls_dn",
            "d0.loss_bbox_dn"}
    assert set(want) == keys and set(got) == keys | {"loss", "grad_norm"}
    for k in keys:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k], float(world["j_metrics"][k]),
                                   rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"], float(sum(want.values())),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"],
                               float(world["j_metrics"]["grad_norm"]),
                               rtol=LOSS_RTOL)


def test_vov_step_runs_both_pack_adjoints(world):
    """The pair level's and the four y-fold levels' adjoints, once each."""
    assert world["adjoints"] == {"pair": 1, "yfold": L - 1}


@pytest.mark.parametrize("part", ["backbone", "neck", "head"])
def test_vov_every_parameter_gradient_matches_jax_grad(world, part):
    """Leaf by leaf under the JAX tree's names, the frozen stem and stage 2
    included (the clip counts their gradients)."""
    got, _ = jax_trees_from_state_dict(
        world["t_grads"], world["variables"]["params"],
        world["variables"]["batch_stats"])
    got, want = _flat(got), _flat(world["j_grads"])
    assert set(got) == set(want)
    leaves = [k for k in want if k.startswith(part + "/")]
    assert len(leaves) > 10
    if part == "backbone":
        assert any(k.startswith("backbone/stem1/") for k in leaves)
    for k in leaves:
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
