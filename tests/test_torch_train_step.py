"""The port's training slice against the JAX package on the CPU, at the
shapes of ``configs/smoke_synthetic.py`` (ResNet-50, FPN 64 ch, Q=16, T=2,
P=2, 2 decoder layers, 2 denoising groups of 8 ground-truth slots, 32x64
images) in fp32, with the JAX weights carried into the port by
``state_dict_from_jax`` after every leaf was overwritten with seeded noise.

How the two sides are made comparable without touching the JAX package:

- dropout: the JAX decoder hard-codes p = 0.1 and draws from its own
  stream, so for the gradient and optimizer comparisons flax's
  ``nn.Dropout.__call__`` is monkeypatched to the identity for the duration
  and the port's ``Dropout.p`` is set to 0. Everything else is the real JAX
  training path (``model.apply(train=True)``: the all-layers classification
  scan, the layer remat, the DN queries, the group-split pack, the custom
  VJPs) and the real ``make_train_step``;
- the augmentations are off in this config (they are held to JAX with
  injected draws in ``test_torch_losses.py``);
- the denoising noise: the draws JAX makes from its key are recomputed here
  and injected into the port's step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from sparsebev_tpu.losses import (compute_detection_loss as j_det_loss,
                                  compute_dn_loss as j_dn_loss,
                                  prepare_dn_inputs as j_prepare_dn)
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.train import optim as joptim
from sparsebev_tpu.train.step import (create_train_state as j_create_state,
                                      make_train_step as j_make_train_step)

from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models import layers as tlayers
from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.train.step import (create_train_state,
                                            make_train_step)
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)

torch.set_num_threads(1)

B, T, N = 1, 2, 6
H, W = 32, 64
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 4, 2
MAX_GT, DN_GROUPS, NUM_CLASSES = 8, 2, 10
PC = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
MODEL = dict(
    type="SparseBEV",
    compute_dtype="float32",
    use_grid_mask=False,
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="ResNet", depth=50, frozen_stages=1,
                      with_cp=True),
    img_neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=C, num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=NUM_CLASSES, in_channels=C,
        num_query=Q, num_frames=T, num_points=P, num_layers=LAYERS,
        num_levels=L, code_size=10, pc_range=PC, num_groups=G,
        mixer_out_points=32, table_gsplit=(False, True, False, False),
        table_gsplit_pack=(False, True, False, False)),
)
OPT = dict(lr=2e-4, weight_decay=0.01, total_steps=100, warmup_iters=10,
           grad_clip=35.0)
CUSTOM_KEYS = {"backbone": 0.1, "sampling_offset": 0.1}
# fp32 through ResNet-50 + FPN + 2 decoder layers: the two frameworks round
# convolutions and reductions differently
OUT_ATOL = 2e-3
# a leaf's gradient against jax.grad: the same rounding differences, carried
# back through the same depth, relative to the leaf's largest entry
GRAD_RTOL = 5e-3


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
        shape = np.asarray(x).shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "in_proj_weight":
            v = rng.randn(*shape) / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "embedding":
            v = rng.randn(*shape)
        elif name == "init_query_bbox":
            v = np.asarray(x) + 0.1 * rng.randn(*shape)
        else:  # biases, BN means
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_model():
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    return JaxSparseBEV(compute_dtype=jnp.float32, **cfg)


def _batch(rng):
    frames = rng.randint(0, 256, (3, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)
    gt_boxes = np.concatenate([
        rng.uniform(-30, 30, (B, MAX_GT, 2)), rng.uniform(-2, 1, (B, MAX_GT, 1)),
        rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
        rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
        rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
    gt_mask = np.zeros((B, MAX_GT), bool)
    gt_mask[:, :5] = True
    gt_boxes[~gt_mask] = 0.0
    gt_labels = rng.randint(0, NUM_CLASSES, (B, MAX_GT)).astype(np.int32)
    # sample 2 of the stream: frames 2 (newest) and 1
    img = np.concatenate([frames[2], frames[1]], axis=1).astype(np.float32)
    return frames, dict(img=img, lidar2img=l2i, time_diff=td,
                        gt_boxes=gt_boxes, gt_labels=gt_labels,
                        gt_mask=gt_mask)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_dn_draws(key, b, g, m):
    k_box, k_label_p, k_label_v = jax.random.split(key, 3)
    return dict(
        box=torch.from_numpy(np.array(jax.random.uniform(
            k_box, (b, g, m, 3), minval=-1.0, maxval=1.0))),
        flip=torch.from_numpy(np.array(jax.random.uniform(
            k_label_p, (b, g, m)))),
        label=torch.from_numpy(np.array(jax.random.randint(
            k_label_v, (b, g, m), 0, NUM_CLASSES))))


def _port_model(variables, dtype="float32"):
    cfg = copy.deepcopy(MODEL)
    cfg["compute_dtype"] = dtype
    model = build_detector({"model": cfg}, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    return model


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    return model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def world():
    """Both models with the same weights, one batch, and on each side: the
    deterministic forward, the DN-on training loss dict with every
    gradient, and the state after one optimizer step."""
    rng = np.random.RandomState(0)
    frames, batch = _batch(rng)
    jmodel = _jax_model()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))
    variables = init({"params": jax.random.PRNGKey(0)}, jb["img"],
                     jb["lidar2img"], jb["time_diff"])
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    out = dict(frames=frames, batch=batch, variables=variables)

    # ---- deterministic forward
    out["j_eval"] = jax.device_get(jax.jit(
        lambda v, *a: jmodel.apply(v, *a, train=False))(
            variables, jb["img"], jb["lidar2img"], jb["time_diff"]))

    # ---- training: JAX side, dropout patched to the identity
    key = jax.random.PRNGKey(7)
    rng_dn, rng_aug, rng_drop = jax.random.split(key, 3)
    gt = (jb["gt_boxes"], jb["gt_labels"], jb["gt_mask"])
    frozen = joptim.resnet_frozen_patterns(1, prefix="backbone")
    tx, _ = joptim.build_optimizer(
        variables["params"], custom_keys=CUSTOM_KEYS, frozen_patterns=frozen,
        **OPT)
    out["mult_tree"] = joptim.build_lr_mult_tree(variables["params"],
                                                 CUSTOM_KEYS, frozen)
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
        out["j_losses"] = jax.device_get(j_losses)
        out["j_grads"] = jax.device_get(j_grads)
        j_step = jax.jit(j_make_train_step(
            jmodel, NUM_CLASSES, CW, PC, Q, query_denoising=True,
            dn_groups=DN_GROUPS))
        state = j_create_state(variables, tx)
        new_state, j_metrics = j_step(state, jb, key)
        out["j_new_params"] = jax.device_get(new_state.params)
        out["j_metrics"] = jax.device_get(j_metrics)
    finally:
        fnn.Dropout.__call__ = real_dropout

    # ---- the port
    tmodel = _no_dropout(_port_model(variables))
    tb = _torch_batch(batch)
    with torch.no_grad():
        out["t_eval"] = {k: v.numpy() for k, v in tmodel(
            tb["img"], tb["lidar2img"], tb["time_diff"]).items()}
    optimizer, scheduler = toptim.build_optimizer(
        tmodel, lr=OPT["lr"], weight_decay=OPT["weight_decay"],
        total_steps=OPT["total_steps"], warmup_iters=OPT["warmup_iters"],
        custom_keys=CUSTOM_KEYS,
        frozen_patterns=toptim.resnet_frozen_patterns(1))
    out["t_mults"] = toptim.build_lr_mult_tree(
        tmodel.named_parameters(), CUSTOM_KEYS,
        toptim.resnet_frozen_patterns(1))
    step = make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=True,
                           dn_groups=DN_GROUPS, grad_clip=OPT["grad_clip"])
    state = create_train_state(tmodel, optimizer, scheduler)
    before = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    # the gradients of the step, read before the optimizer consumes them
    grads = {}
    real_clip = toptim.clip_by_global_norm

    def clip_and_record(params, max_norm):
        grads.update({k: p.grad.detach().clone()
                      for k, p in tmodel.named_parameters()})
        return real_clip(params, max_norm)

    import sparsebev_tpu_torch.train.step as tstep
    tstep.clip_by_global_norm = clip_and_record
    try:
        _, t_metrics = step(
            state, tb, generator=torch.Generator().manual_seed(0),
            draws=dict(dn=_jax_dn_draws(rng_dn, B, DN_GROUPS, MAX_GT)))
    finally:
        tstep.clip_by_global_norm = real_clip
    out.update(tmodel=tmodel, t_metrics={k: float(v) for k, v in
                                         t_metrics.items()},
               t_grads=grads, t_before=before, state=state)
    return out


# ------------------------------------------------------- (a) full forward --

def test_full_forward_matches_jax_apply(world):
    for key in ("all_cls_scores", "all_bbox_preds"):
        got, want = world["t_eval"][key], world["j_eval"][key]
        assert got.shape == want.shape == (LAYERS, B, Q, 10)
        np.testing.assert_allclose(got[-1], want[-1], rtol=0, atol=OUT_ATOL)
    np.testing.assert_array_equal(world["t_eval"]["all_cls_scores"][:-1],
                                  -1e4)
    np.testing.assert_allclose(world["t_eval"]["all_bbox_preds"],
                               world["j_eval"]["all_bbox_preds"], rtol=0,
                               atol=OUT_ATOL)


def test_full_forward_matches_the_streaming_path(world):
    """The same frames through the port's own streaming path (one new frame
    a sample, ring tables) give the full forward's outputs: the convolutions
    see 6 images instead of 12, nothing else differs."""
    frames, batch = world["frames"], world["batch"]
    # a fresh copy of the weights: the fixture's model has taken a step
    det = StreamingDetector(_port_model(world["variables"]), num_frames=T,
                            cache_size=T, device="cpu")
    for i in range(3):
        ids = [i, max(i - 1, 0)]
        names = [f"/data/sweeps/f{j}_cam{v}.jpg" for j in ids
                 for v in range(N)]
        out = det.infer(frames[i], batch["lidar2img"], batch["time_diff"],
                        names)
    for key in ("all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(out[key].numpy()[-1],
                                   world["t_eval"][key][-1], rtol=0,
                                   atol=1e-4)


# ------------------------------------------- (b) loss dict and gradients --

def test_training_loss_dict_matches_jax(world):
    want, got = world["j_losses"], world["t_metrics"]
    keys = {"loss_cls", "loss_bbox", "d0.loss_cls", "d0.loss_bbox",
            "loss_cls_dn", "loss_bbox_dn", "d0.loss_cls_dn",
            "d0.loss_bbox_dn"}
    assert set(want) == keys and set(got) == keys | {"loss", "grad_norm"}
    for k in keys:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-3,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"], float(sum(want.values())),
                               rtol=2e-3)
    # and against the real JAX train step's metrics
    for k in keys | {"loss"}:
        np.testing.assert_allclose(got[k], float(world["j_metrics"][k]),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def _grad_trees(world):
    got, _ = jax_trees_from_state_dict(
        world["t_grads"], world["variables"]["params"],
        world["variables"]["batch_stats"])
    return _flat(got), _flat(world["j_grads"])


@pytest.mark.parametrize("part", ["backbone", "neck", "head"])
def test_every_parameter_gradient_matches_jax_grad(world, part):
    """Leaf by leaf, under the JAX tree's names: every parameter of the
    part, the frozen stem and layer1 included (they still get gradients)."""
    got, want = _grad_trees(world)
    leaves = [k for k in want if k.startswith(part + "/")]
    assert len(leaves) > 10
    for k in leaves:
        assert got[k] is not None, k
        scale = np.abs(want[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    assert set(got) == set(want)


def test_query_box_gradient_matches_jax_grad(world):
    """``init_query_bbox`` is the one box that carries a gradient into the
    decoder (layers 1.. refine a detached box): its gradient equals JAX's
    only with the box detached in the attention's distance term and in the
    velocity warp, as ``decoder.py:47`` and ``:109`` of the JAX package
    do."""
    got, want = _grad_trees(world)
    k = "head/init_query_bbox"
    scale = np.abs(want[k]).max()
    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-3 * scale)
    # velocity columns: reached through the refinement alone
    np.testing.assert_allclose(got[k][:, 8:], want[k][:, 8:], rtol=0,
                               atol=2e-3 * max(np.abs(want[k][:, 8:]).max(),
                                               1e-12))


# -------------------------------------------------- (c) one optimizer step --

def test_multiplier_tree_matches_jax(world):
    """The port's per-parameter multipliers, carried into the JAX tree's
    layout, equal ``build_lr_mult_tree``'s leaf by leaf."""
    model = world["tmodel"]
    tensors = {n: torch.full_like(p, world["t_mults"][n])
               for n, p in model.named_parameters()}
    got, _ = jax_trees_from_state_dict(
        tensors, world["variables"]["params"],
        world["variables"]["batch_stats"])
    got, want = _flat(got), _flat(world["mult_tree"])
    assert set(got) == set(want)
    for k in want:
        assert bool((got[k] == np.float32(want[k])).all()), k
    assert set(world["t_mults"].values()) == {0.0, 0.1, 1.0}


def test_one_optimizer_step_matches_jax_state(world):
    """Parameters after clip + AdamW + multipliers + schedule against
    ``state.apply_gradients``. At step 1 Adam's update is ``g / (|g| + eps)``,
    so where a gradient entry is within rounding of zero its sign, and with
    it the whole update, is noise: those entries are bounded by the step
    size, all others are held tight."""
    model = world["tmodel"]
    got, _ = jax_trees_from_state_dict(
        dict(model.named_parameters()), world["variables"]["params"],
        world["variables"]["batch_stats"])
    got = _flat(got)
    want = _flat(world["j_new_params"])
    old = _flat(world["variables"]["params"])
    grads = _flat(world["j_grads"])
    t_grads, _ = _grad_trees(world)
    mults = _flat(world["mult_tree"])
    lr0 = OPT["lr"] / 3          # the schedule's first step (warmup ratio)
    clip_scale = min(1.0, OPT["grad_clip"] / world["t_metrics"]["grad_norm"])
    robust = total = 0
    for k in want:
        d_got, d_want = got[k] - old[k], want[k] - old[k]
        if mults[k] == 0.0:
            np.testing.assert_array_equal(got[k], old[k], err_msg=k)
            np.testing.assert_array_equal(want[k], old[k], err_msg=k)
            continue
        # firm: the two sides' gradients agree on the entry's sign with a
        # wide margin, and the clipped entry is far above Adam's eps
        firm = (np.abs(grads[k]) > 10 * np.abs(t_grads[k] - grads[k])) \
            & (np.abs(grads[k]) * clip_scale > 1e-4)
        # 0.2% of the step, plus an fp32 ulp of the parameter itself
        tol = 2e-3 * lr0 * mults[k] + 2.5e-7 * np.abs(old[k])
        assert bool((np.abs(d_got - d_want)[firm] <= tol[firm]).all()), k
        assert np.abs(d_got - d_want).max() <= 2.05 * lr0 * mults[k], k
        assert np.abs(d_want[firm]).max() > 0.5 * lr0 * mults[k], k
        robust += int(firm.sum())
        total += firm.size
    # measured: 44% of the 24.0M entries are firm (the clip scales the
    # gradients by 0.053 here, which leaves many conv entries near eps)
    assert robust > 0.3 * total, (robust, total, clip_scale)
    assert world["state"].step == 1


def test_grad_norm_matches_jax(world):
    np.testing.assert_allclose(world["t_metrics"]["grad_norm"],
                               float(world["j_metrics"]["grad_norm"]),
                               rtol=2e-3)
    want = float(optax.global_norm(world["j_grads"]))
    np.testing.assert_allclose(world["t_metrics"]["grad_norm"], want,
                               rtol=2e-3)


def test_frozen_parameters_keep_their_gradients_but_do_not_move(world):
    model, before = world["tmodel"], world["t_before"]
    frozen = [k for k, m in world["t_mults"].items() if m == 0.0]
    assert any(k.startswith("img_backbone.conv1.") for k in frozen)
    assert any(k.startswith("img_backbone.layer1.") for k in frozen)
    assert not any(k.startswith("img_backbone.layer2.") for k in frozen)
    params = dict(model.named_parameters())
    for k in frozen:
        assert params[k].requires_grad
        assert bool(world["t_grads"][k].abs().sum() > 0), k
        assert torch.equal(params[k], before[k]), k
    moved = [k for k in params if k not in frozen
             and not torch.equal(params[k], before[k])]
    assert len(moved) == len(params) - len(frozen)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_adamw_groups_match_the_optax_chain(max_norm):
    """The optimizer alone on identical gradients, three steps, with 0x,
    0.1x and 1x multipliers and the clip active (0.5) and idle (1e6): the
    decay after Adam scaled by ``mult * lr`` and the clip before the
    multipliers, as optax chains them."""
    rng = np.random.RandomState(3)
    shapes = {"img_backbone.conv1.weight": (4, 3), "img_backbone.layer2.w": (5,),
              "head.sampling_offset.weight": (3, 2), "head.other.weight": (6,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    frozen_j, frozen_t = ["img_backbone.conv1"], ["img_backbone.conv1."]
    kw = dict(lr=1e-2, weight_decay=0.1, total_steps=20, warmup_iters=2)
    tx, _ = joptim.build_optimizer(
        {k: jnp.asarray(v) for k, v in init.items()}, grad_clip=max_norm,
        custom_keys=CUSTOM_KEYS, frozen_patterns=frozen_j, **kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ps = torch.nn.ParameterDict(
                {k.replace(".", "/"): torch.nn.Parameter(torch.from_numpy(v))
                 for k, v in init.items()})

        def named_parameters(self, *a, **k):
            return [(n.split(".", 1)[1].replace("/", "."), p)
                    for n, p in super().named_parameters(*a, **k)]

    holder = Holder()
    optimizer, scheduler = toptim.build_optimizer(
        holder, custom_keys=CUSTOM_KEYS, frozen_patterns=frozen_t, **kw)
    tparams = dict(holder.named_parameters())
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = toptim.clip_by_global_norm(list(tparams.values()), max_norm)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(
                {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        optimizer.step()
        scheduler.step()
    for k in init:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(
        tparams["img_backbone.conv1.weight"].detach().numpy(),
        init["img_backbone.conv1.weight"])


# ------------------------------------------------------------ (d) dropout --

def _observe_dropouts(module):
    seen = {}
    handles = []
    for name, m in module.named_modules():
        if isinstance(m, tlayers.Dropout):
            handles.append(m.register_forward_hook(
                lambda mod, args, out, name=name: seen.__setitem__(
                    name, (args[0].detach().clone(), out.detach().clone()))))
    return seen, handles


def test_dropout_sites_drop_in_training_and_are_the_identity_in_eval():
    """The four JAX sites (attention weights, attention output, after each
    FFN linear), p = 0.1 under an explicit generator: about a tenth of the
    entries are zeroed, the rest scaled by 1 / 0.9; deterministic calls
    return the input itself."""
    torch.manual_seed(0)
    attn = tlayers.MultiheadAttention(64, 8)
    ffn = tlayers.FFN(64, 128)
    x = torch.randn(2, 50, 64)
    sites = {}
    for mod in (attn, ffn):
        tlayers.set_dropout_generator(mod, torch.Generator().manual_seed(1))
        seen, handles = _observe_dropouts(mod)
        out_train = mod(x, deterministic=False)
        sites.update(seen.copy())
        for name, (inp, out) in seen.items():
            dropped = (out == 0) & (inp != 0)
            share = float(dropped.float().sum() / (inp != 0).sum())
            assert 0.07 < share < 0.13, (name, share)
            kept = ~dropped & (inp != 0)
            torch.testing.assert_close(out[kept], inp[kept] / 0.9)
        seen.clear()
        out_eval = mod(x, deterministic=True)
        for name, (inp, out) in seen.items():
            assert torch.equal(inp, out), name
        assert not torch.equal(out_train, out_eval)
        # the same generator state gives the same step
        tlayers.set_dropout_generator(mod, torch.Generator().manual_seed(1))
        assert torch.equal(mod(x, deterministic=False), out_train)
        for h in handles:
            h.remove()
    assert sorted(sites) == ["attn_drop", "drop1", "drop2", "proj_drop"]


def test_bool_attention_mask_blocks_with_minus_inf():
    torch.manual_seed(0)
    attn = tlayers.MultiheadAttention(32, 4)
    x = torch.randn(1, 6, 32)
    mask = torch.zeros(4, 6, 6, dtype=torch.bool)
    mask[:, :, 4:] = True                   # nobody sees the last two
    mask[:, 4:, 4:] = False
    mask[:, 4:, :4] = True                  # and they see only themselves
    out = attn(x, attn_mask=mask)
    x2 = x.clone()
    x2[:, 4:] += 10.0
    out2 = attn(x2, attn_mask=mask)
    torch.testing.assert_close(out[:, :4], out2[:, :4])
    additive = torch.zeros(4, 6, 6).masked_fill(mask, float("-inf"))
    torch.testing.assert_close(attn(x, attn_mask=additive), out)


# ----------------------------------------------- repairs, in bf16 (tiny) --

def test_every_parameter_trains_in_bf16(world):
    """bf16 compute, fp32 parameters: after one backward of the DN-on loss
    every parameter that ``named_parameters()`` lists has a non-zero
    gradient: the Linear and attention weights (their bf16 casts are made
    inside the graph), every backbone conv and BN affine (the conv + BN
    fold likewise), the FPN, the embeddings."""
    model = _port_model(world["variables"], dtype="bfloat16")
    tb = _torch_batch(world["batch"])
    gen = torch.Generator().manual_seed(0)
    step = make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=True,
                           dn_groups=DN_GROUPS)
    grads = {}

    class Probe(torch.optim.SGD):
        def step(self):
            grads.update({k: p.grad for k, p in model.named_parameters()})

    state = create_train_state(model, Probe(model.parameters(), lr=0.0))
    _, metrics = step(state, tb, generator=gen)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    missing = [k for k, g in grads.items() if g is None]
    assert not missing, missing
    dead = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    assert not dead, dead
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert len(grads) == len(list(model.named_parameters())) > 200


def test_inference_casts_stay_cached_and_training_casts_do_not():
    lin = tlayers.Linear(8, 4)
    x = torch.randn(3, 8).bfloat16()
    with torch.no_grad():
        lin(x)
        w1 = lin._casts.get("weight", lin.weight, torch.bfloat16)
        assert w1 is lin._casts.get("weight", lin.weight, torch.bfloat16)
    out = lin(x)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert lin.weight.grad is not None and lin.bias.grad is not None
    assert bool(lin.weight.grad.abs().sum() > 0)


def test_random_init_model_takes_a_step_with_augmentation():
    """The step as a user calls it: seeded random weights, every
    augmentation on, dropout on, draws from one generator; two steps on the
    same batch with the same generator seed are reproducible."""
    cfg = copy.deepcopy(MODEL)
    cfg["use_grid_mask"] = True
    cfg["data_aug"]["img_color_aug"] = True
    cfg["stop_prev_grad"] = 1
    _, batch = _batch(np.random.RandomState(1))
    tb = _torch_batch(batch)
    step = make_train_step(NUM_CLASSES, CW, PC, Q, dn_groups=DN_GROUPS)
    losses = []
    for _ in range(2):
        model = random_init_(build_detector({"model": cfg}, device="cpu"), 0)
        opt, sched = toptim.build_optimizer(
            model, total_steps=10, warmup_iters=2, custom_keys=CUSTOM_KEYS,
            frozen_patterns=toptim.resnet_frozen_patterns(1))
        state = create_train_state(model, opt, sched)
        _, m = step(state, tb, generator=torch.Generator().manual_seed(5))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0
    assert losses[0] == losses[1]
