"""One DN-on training step of a small EVA02 SparseBEV in the port against
the JAX train step on the CPU, at fp32.

The small EVA02: embed 64, 4 heads of 16, depth 4 (blocks 0, 1 and 3
windowed over a 4x6 token grid padded to 4x8 by 4x4 windows, block 2
global), drop path 0.3 (rates 0, 0.1, 0.2, 0.3 by block), the block remat
(``use_act_checkpoint``) and ``frozen_blocks=1``, as
``configs/vit_eva02_1600x640_trainval_future.py`` sets them; its pyramid at
four scales with the top block, 32 channels, 5 levels (a pair-mode level
0); ``stop_prev_grad=1`` with T=3: 6 images carry gradients, 12 run in the
detached pass; Q=16, P=2, 2 decoder layers, 2 denoising groups of 8
ground-truth slots, 64x96 images. The JAX weights are carried into the port
by ``state_dict_from_jax`` after every leaf was overwritten with seeded
noise.

How the two sides draw the same masks without touching the JAX package:
the drop-path masks are made here with numpy, one per (block, site, pass),
and handed to both: to the port through its step's ``draws["drop_path"]``
(``models/layers.py::DropPath``), to JAX by replacing the module attribute
``sparsebev_tpu.models.eva02.drop_path`` for the duration (keyed by the
block's rate, which ``linspace`` makes unique, the batch size, which tells
the gradient pass from the detached one, and the site: the attention's
first, the MLP's second). The decoder's dropout is off on both sides and
the denoising draws JAX makes from its key are injected into the port's
step (see ``test_torch_train_step.py``).
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
from sparsebev_tpu.models import eva02 as jeva
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.train import optim as joptim
from sparsebev_tpu.train.step import (create_train_state as j_create_state,
                                      make_train_step as j_make_train_step)

from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.train import step as tstep
from sparsebev_tpu_torch.train.step import create_train_state, make_train_step
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)

from test_torch_streaming import PC, make_cameras, noise_tree
from test_torch_train_step import _flat, _jax_dn_draws, _no_dropout

torch.set_num_threads(1)

B, T, N = 1, 3, 6
H, W = 64, 96
C, Q, P, L, LAYERS = 32, 16, 2, 5, 2
MAX_GT, DN_GROUPS, NUM_CLASSES = 8, 2, 10
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
DEPTH, RATE, STOP_PREV_GRAD = 4, 0.3, 1
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
BACKBONE = dict(type="EVA02", img_size=64, real_img_size=(H, W),
                patch_size=16, embed_dim=64, depth=DEPTH, num_heads=4,
                drop_path_rate=RATE, window_size=4,
                window_block_indexes=(0, 1, 3), use_act_checkpoint=True,
                frozen_blocks=1, fpn_out_channels=C,
                fpn_scale_factors=(4.0, 2.0, 1.0, 0.5), fpn_top_block=True,
                pretrain_img_size=32)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    use_grid_mask=False,
    stop_prev_grad=STOP_PREV_GRAD,
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=BACKBONE,
    img_neck=None,
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=NUM_CLASSES, in_channels=C,
        num_query=Q, num_frames=T, num_points=P, num_layers=LAYERS,
        num_levels=L, code_size=10, pc_range=PC, num_groups=4,
        mixer_out_points=32, table_yfold=(False, True, True, True, True)),
)
OPT = dict(lr=2e-4, weight_decay=0.01, total_steps=100, warmup_iters=10,
           grad_clip=35.0)
CUSTOM_KEYS = {"backbone": 0.1, "sampling_offset": 0.1}
# fp32 through 4 ViT blocks, the pyramid and 2 decoder layers: the two
# frameworks sum products and reductions in other orders (the EVA02 units
# agree within 1e-5 of their scale, tests/test_torch_eva02.py); the loss
# dict relative, each gradient leaf against its largest entry, carried back
# through the same depth (test_torch_train_step.py's tolerances)
LOSS_RTOL = 2e-3
GRAD_RTOL = 5e-3
RATES = [float(r) for r in np.linspace(0, RATE, DEPTH)]
GRAD_IMAGES = STOP_PREV_GRAD * N
PASSES = (GRAD_IMAGES, T * N - GRAD_IMAGES)     # 6 and 12 images


def _masks(rng):
    """One keep mask a (block, site, pass) for every block whose rate is
    above 0, drawn at the block's keep probability, each holding a drop."""
    masks = {}
    for blk, rate in enumerate(RATES):
        if rate <= 0:
            continue
        for site in (0, 1):
            for n in PASSES:
                m = rng.uniform(size=n) < 1.0 - rate
                m[rng.randint(n)] = False
                masks[(blk, site, n)] = m
    return masks


def _jax_drop_path(masks, calls):
    """``jeva.drop_path`` with the masks above: the block from the rate, the
    pass from the batch size, the site from the order of the block's calls
    (the attention's first, then the MLP's)."""
    count = {}

    def drop_path(rng, x, rate):
        n = x.shape[0]
        blk = RATES.index(rate)
        site = count.get((blk, n), 0) % 2
        count[(blk, n)] = count.get((blk, n), 0) + 1
        calls.add((blk, site, n))
        keep = 1.0 - rate
        mask = jnp.asarray(masks[(blk, site, n)]).reshape(
            (n,) + (1,) * (x.ndim - 1))
        return x * mask / keep

    return drop_path


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
        lidar2img=l2i,
        time_diff=np.asarray([[0.0, 0.5, 1.0]], np.float32),
        gt_boxes=gt_boxes,
        gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)).astype(np.int32),
        gt_mask=gt_mask)


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    masks = _masks(rng)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0)}, jb["img"], jb["lidar2img"],
        jb["time_diff"])
    # (EVA02 keeps no batch statistics; the head neither)
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": {}}
    key = jax.random.PRNGKey(7)
    rng_dn, rng_aug, rng_drop = jax.random.split(key, 3)
    gt = (jb["gt_boxes"], jb["gt_labels"], jb["gt_mask"])
    frozen = joptim.backbone_frozen_patterns(BACKBONE, prefix="backbone")
    tx, _ = joptim.build_optimizer(
        variables["params"], custom_keys=CUSTOM_KEYS, frozen_patterns=frozen,
        **OPT)
    mult_tree = joptim.build_lr_mult_tree(variables["params"], CUSTOM_KEYS,
                                          frozen)
    j_calls = set()
    real_dropout = fnn.Dropout.__call__
    real_drop_path = jeva.drop_path
    fnn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
    jeva.drop_path = _jax_drop_path(masks, j_calls)
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
        new_state, j_metrics = jax.jit(j_make_train_step(
            jmodel, NUM_CLASSES, CW, PC, Q, query_denoising=True,
            dn_groups=DN_GROUPS))(j_create_state(variables, tx), jb, key)
    finally:
        fnn.Dropout.__call__ = real_dropout
        jeva.drop_path = real_drop_path

    model = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    _no_dropout(model)
    optimizer, scheduler = toptim.build_optimizer(
        model, lr=OPT["lr"], weight_decay=OPT["weight_decay"],
        total_steps=OPT["total_steps"], warmup_iters=OPT["warmup_iters"],
        custom_keys=CUSTOM_KEYS,
        frozen_patterns=toptim.backbone_frozen_patterns(BACKBONE))
    grads, t_calls = {}, []
    real_clip = tstep.clip_by_global_norm

    def clip_and_record(params, max_norm):
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
        return real_clip(params, max_norm)

    def draws(blk, site, n):
        t_calls.append((blk, site, n))
        return torch.from_numpy(masks[(blk, site, n)])

    tstep.clip_by_global_norm = clip_and_record
    try:
        step = make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=True,
                               dn_groups=DN_GROUPS,
                               grad_clip=OPT["grad_clip"])
        _, t_metrics = step(
            create_train_state(model, optimizer, scheduler),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            generator=torch.Generator().manual_seed(0),
            draws=dict(dn=_jax_dn_draws(rng_dn, B, DN_GROUPS, MAX_GT),
                       drop_path=draws))
    finally:
        tstep.clip_by_global_norm = real_clip
    return dict(variables=variables, masks=masks, model=model,
                mult_tree=mult_tree,
                j_losses=jax.device_get(j_losses),
                j_grads=jax.device_get(j_grads),
                j_metrics=jax.device_get(j_metrics),
                j_new_params=jax.device_get(new_state.params),
                j_calls=j_calls, t_calls=t_calls,
                t_metrics={k: float(v) for k, v in t_metrics.items()},
                t_grads=grads)


def test_eva02_training_loss_dict_matches_jax(world):
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


def test_eva02_both_sides_used_every_mask(world):
    """JAX traced every (block, site, pass) mask; the port drew each in the
    gradient pass, then the detached pass, each block's attention site
    before its MLP site, block 0 (rate 0) never; then the block remat's
    recompute drew the gradient pass's masks again, last block first."""
    assert world["j_calls"] == set(world["masks"])
    sites = [(blk, s) for blk in range(1, DEPTH) for s in (0, 1)]
    forward = [(blk, s, n) for n in PASSES for blk, s in sites]
    recompute = [(blk, s, PASSES[0]) for blk in range(DEPTH - 1, 0, -1)
                 for s in (0, 1)]
    assert world["t_calls"] == forward + recompute
    drops = sum(int((~m).sum()) for m in world["masks"].values())
    assert drops >= len(world["masks"])


@pytest.mark.parametrize("part", ["backbone/vit", "backbone/sfp", "head"])
def test_eva02_every_parameter_gradient_matches_jax_grad(world, part):
    """Leaf by leaf under the JAX tree's names; the frozen block 0, patch
    embed and position embedding included (the clip counts their
    gradients)."""
    got, _ = jax_trees_from_state_dict(
        world["t_grads"], world["variables"]["params"],
        world["variables"]["batch_stats"])
    got, want = _flat(got), _flat(world["j_grads"])
    assert set(got) == set(want)
    leaves = [k for k in want if k.startswith(part + "/")]
    assert len(leaves) > 10
    if part == "backbone/vit":
        assert any(k.startswith("backbone/vit/block0/") for k in leaves)
    for k in leaves:
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)


def test_eva02_one_optimizer_step_matches_jax_state(world):
    """Parameters after clip + AdamW + multipliers + schedule against the
    JAX step's state, as ``test_torch_train_step.py`` holds the r50 step:
    the frozen leaves (patch embed, position embedding, block 0) unchanged
    on both sides; where the two sides' gradients agree on an entry's sign
    with a wide margin (Adam's first update is ``g / (|g| + eps)``) within
    0.2% of the step, elsewhere within the step's size."""
    model = world["model"]
    got, _ = jax_trees_from_state_dict(
        dict(model.named_parameters()), world["variables"]["params"],
        world["variables"]["batch_stats"])
    t_grads, _ = jax_trees_from_state_dict(
        world["t_grads"], world["variables"]["params"],
        world["variables"]["batch_stats"])
    got, t_grads = _flat(got), _flat(t_grads)
    want = _flat(world["j_new_params"])
    old = _flat(world["variables"]["params"])
    grads = _flat(world["j_grads"])
    mults = _flat(world["mult_tree"])
    lr0 = OPT["lr"] / 3          # the schedule's first step (warmup ratio)
    clip_scale = min(1.0, OPT["grad_clip"] / world["t_metrics"]["grad_norm"])
    frozen = {k for k, m in mults.items() if m == 0.0}
    assert any(k.startswith("backbone/vit/block0/") for k in frozen)
    assert not any(k.startswith("backbone/vit/block1/") for k in frozen)
    robust = total = 0
    for k in want:
        d_got, d_want = got[k] - old[k], want[k] - old[k]
        if k in frozen:
            np.testing.assert_array_equal(got[k], old[k], err_msg=k)
            np.testing.assert_array_equal(want[k], old[k], err_msg=k)
            assert np.abs(t_grads[k]).max() > 0, k   # a gradient all the same
            continue
        firm = (np.abs(grads[k]) > 10 * np.abs(t_grads[k] - grads[k])) \
            & (np.abs(grads[k]) * clip_scale > 1e-4)
        tol = 2e-3 * lr0 * mults[k] + 2.5e-7 * np.abs(old[k])
        assert bool((np.abs(d_got - d_want)[firm] <= tol[firm]).all()), k
        assert np.abs(d_got - d_want).max() <= 2.05 * lr0 * mults[k], k
        robust += int(firm.sum())
        total += firm.size
    assert robust > 0.3 * total, (robust, total, clip_scale)
