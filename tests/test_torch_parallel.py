"""Data parallelism and query-sharded training in the port against the JAX
package's global-batch step on the CPU, two gloo ranks in two processes
(``tests/torch_ranks.py``): one DN-on step of a small VoVNet SparseBEV
(V-19-slim-eSE, FPN 32 ch, Q=25, T=2, P=2, 2 decoder layers, 2 denoising
groups of 8 ground-truth slots, 64x128 images, fp32, dropout and every
augmentation off as in ``test_torch_runner.py``) on a global batch of 2.

- data-parallel: each rank takes one sample (and its slice of the denoising
  draws JAX makes from its key); the loss normalizers sum over the ranks and
  the gradients sum after the backward;
- query-sharded (dp 1 x sp 2): both ranks take the whole batch and split the
  41 decoder queries (16 denoising + 25) 21 / 20 between them.

The same step in one process over the whole batch, and the train CLI's
grouping of three ranks at the batch of 2 (two train, the third leaves),
are held the same way. Each is held to the JAX step at B=2
(``jax.value_and_grad`` of the loss and the optax update of
``make_train_step``'s optimizer): the loss dict and the
gradient norm, every parameter gradient, and the parameters after one AdamW
step. Last, the train CLI's ``--multihost`` under a ``torchrun``
environment of one gloo rank gives the bits of a run without it.
"""

import copy
import os
import socket

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from sparsebev_tpu.losses import (compute_detection_loss as j_det_loss,
                                  compute_dn_loss as j_dn_loss,
                                  prepare_dn_inputs as j_prepare_dn)
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.train import optim as joptim

from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.utils.convert import (jax_trees_from_state_dict,
                                               state_dict_from_jax)

from test_torch_runner import CUSTOM_KEYS, GRAD_CLIP, OPT
from test_torch_runner import MODEL as RUNNER_MODEL
from test_torch_streaming import PC, make_cameras, noise_tree
from test_torch_train_step import GRAD_RTOL, _flat, _jax_dn_draws
from torch_ranks import run_ranks, train_step_rank

torch.set_num_threads(1)

B, T, N = 2, 2, 6
H, W = 64, 128
Q, MAX_GT, DN_GROUPS, NUM_CLASSES = 25, 8, 2, 10
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
MODEL = copy.deepcopy(RUNNER_MODEL)
MODEL["pts_bbox_head"]["num_query"] = Q
# the step over a split batch against JAX's global batch: the runner's
# step-1 tolerance (the same fp32 kernels, reductions in another order)
LOSS_RTOL = 1e-5


def _batch(rng):
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4).astype(np.float32)
    gt_boxes = np.concatenate([
        rng.uniform(-30, 30, (B, MAX_GT, 2)),
        rng.uniform(-2, 1, (B, MAX_GT, 1)),
        rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
        rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
        rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
    # the two samples hold different counts of boxes: the normalizers must
    # be the batch's, not a rank's
    gt_mask = np.zeros((B, MAX_GT), bool)
    gt_mask[0, :5] = True
    gt_mask[1, :2] = True
    gt_boxes[~gt_mask] = 0.0
    return dict(
        img=rng.randint(0, 256, (B, T * N, H, W, 3)).astype(np.float32),
        lidar2img=l2i, time_diff=np.tile(np.asarray([[0.0, 0.5]],
                                                    np.float32), (B, 1)),
        gt_boxes=gt_boxes,
        gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)).astype(np.int32),
        gt_mask=gt_mask)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0)}, jb["img"][:1],
        jb["lidar2img"][:1], jb["time_diff"][:1])
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    rng_dn, rng_aug, rng_drop = jax.random.split(jax.random.PRNGKey(7), 3)
    gt = (jb["gt_boxes"], jb["gt_labels"], jb["gt_mask"])
    frozen = joptim.backbone_frozen_patterns(MODEL["img_backbone"],
                                             prefix="backbone")
    tx, _ = joptim.build_optimizer(
        variables["params"], grad_clip=GRAD_CLIP, custom_keys=CUSTOM_KEYS,
        frozen_patterns=frozen, **OPT)
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

        (total, j_losses), j_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    finally:
        fnn.Dropout.__call__ = real_dropout
    # make_train_step's update: state.apply_gradients(grads)
    updates, _ = tx.update(j_grads, tx.init(variables["params"]),
                           variables["params"])
    j_new = optax.apply_updates(variables["params"], updates)

    work = tmp_path_factory.mktemp("torch_parallel")
    torch.save(dict(
        model=MODEL,
        state_dict=state_dict_from_jax(variables["params"],
                                       variables["batch_stats"]),
        opt=dict(lr=OPT["lr"], weight_decay=OPT["weight_decay"],
                 total_steps=OPT["total_steps"],
                 warmup_iters=OPT["warmup_iters"], custom_keys=CUSTOM_KEYS,
                 frozen_patterns=toptim.vovnet_frozen_patterns(1)),
        step=dict(num_classes=NUM_CLASSES, code_weights=CW, pc_range=PC,
                  num_query=Q, query_denoising=True, dn_groups=DN_GROUPS,
                  grad_clip=GRAD_CLIP),
        batch={k: torch.from_numpy(v) for k, v in batch.items()},
        dn=_jax_dn_draws(rng_dn, B, DN_GROUPS, MAX_GT)),
        os.path.join(work, "step_inputs.pt"))
    return dict(work=work, variables=variables,
                j_losses={k: float(v) for k, v in
                          jax.device_get(j_losses).items()},
                j_total=float(total),
                j_grad_norm=float(optax.global_norm(j_grads)),
                j_grads=_flat(jax.device_get(j_grads)),
                j_new=_flat(jax.device_get(j_new)),
                mults=_flat(joptim.build_lr_mult_tree(
                    variables["params"], CUSTOM_KEYS, frozen)), runs={})


def _run(world, mode):
    """The port's step over ``MODES[mode]`` = (ranks, query shards)
    (cached)."""
    if mode not in world["runs"]:
        ranks, sp = MODES[mode]
        if ranks == 1:      # no process group: the step in this process
            train_step_rank(0, 1, world["work"], sp)
        else:
            run_ranks(train_step_rank, ranks, world["work"], sp)
        out = torch.load(os.path.join(world["work"],
                                      f"step_w{ranks}_sp{sp}.pt"))
        v = world["variables"]
        grads, _ = jax_trees_from_state_dict(out["grads"], v["params"],
                                             v["batch_stats"])
        params, _ = jax_trees_from_state_dict(out["params"], v["params"],
                                              v["batch_stats"])
        world["runs"][mode] = dict(metrics=out["metrics"],
                                   grads=_flat(grads), params=_flat(params))
    return world["runs"][mode]


# (ranks, query shards): two ranks data-parallel or query-sharded; three
# ranks grouped as the train CLI groups them (sp None: the largest world
# that divides the batch of 2, so two ranks train and the third leaves);
# one process over the whole batch of 2, no process group (no
# batch-dependent operation in the port's step: it meets JAX's batch of 2
# as the split batch does)
MODES = {"data_parallel": (2, 1), "query_sharded": (2, 2),
         "three_ranks_batch_of_2": (3, None), "one_process_batch_of_2": (1, 1)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_rank_loss_dict_matches_jax_global_batch(world, mode):
    got = _run(world, mode)["metrics"]
    want = world["j_losses"]
    assert set(got) == set(want) | {"loss", "grad_norm"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"], world["j_total"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], world["j_grad_norm"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_rank_gradients_match_jax_global_batch(world, mode):
    """Every parameter's gradient, summed over the ranks (read before the
    clip), leaf by leaf against ``jax.grad`` of the global-batch loss, to
    ``test_torch_train_step.py``'s share of each leaf's largest entry (the
    two frameworks' fp32 convolutions round differently)."""
    got, want = _run(world, mode)["grads"], world["j_grads"]
    assert set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_RTOL * max(scale, 1e-12),
                                   err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_rank_adamw_step_matches_jax(world, mode):
    """The parameters after the clip and one AdamW step (multipliers,
    frozen stages, schedule) against the optax update, held as
    ``test_torch_train_step.py`` holds one step: where a gradient entry is
    within rounding of zero Adam's ``g / (|g| + eps)`` is a full step either
    way, so those entries are bounded by the step size and the others are
    held within 0.2% of it."""
    run = _run(world, mode)
    lr0 = OPT["lr"] / 3
    clip_scale = min(1.0, GRAD_CLIP / world["j_grad_norm"])
    old = _flat(world["variables"]["params"])
    for k, want in world["j_new"].items():
        got, mult, g = run["params"][k], world["mults"][k], \
            world["j_grads"][k]
        if mult == 0.0:
            np.testing.assert_array_equal(got, old[k], err_msg=k)
            continue
        # firm: the two sides agree on the entry's sign with a wide margin
        # and the clipped entry is far above Adam's eps
        firm = (np.abs(g) > 10 * np.abs(run["grads"][k] - g)) \
            & (np.abs(g) * clip_scale > 1e-4)
        tol = 2e-3 * lr0 * mult + 2.5e-7 * np.abs(old[k])
        d = np.abs((got - old[k]) - (want - old[k]))
        assert bool((d[firm] <= tol[firm]).all()), k
        assert d.max() <= 2.05 * lr0 * mult, k


def test_three_ranks_train_the_batch_of_2_on_two(world):
    """Three ranks at a global batch of 2 (the JAX train CLI's
    ``make_mesh_for_batch``): ranks 0 and 1 run the two-rank data-parallel
    step bit for bit, and rank 2 leaves before the step, holding no
    collective (if it held one, the ranks would wait out their timeout)."""
    got = _run(world, "three_ranks_batch_of_2")
    want = _run(world, "data_parallel")
    assert got["metrics"] == want["metrics"]
    for part in ("grads", "params"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    left = torch.load(os.path.join(world["work"], "left_rank2.pt"))
    assert left == dict(world=3, dp=2)
    assert not os.path.exists(os.path.join(world["work"], "left_rank1.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
