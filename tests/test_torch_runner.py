"""The port's training loop against the JAX package's on the CPU: the
``Runner`` with its hooks, ``make_multi_step``, checkpoints and resume.

The JAX comparison runs both ``Runner``s for 2 epochs x 2 iterations on a
small VoVNet SparseBEV (V-19-slim-eSE, FPN 32 ch, Q=16, T=2, P=2, 2 decoder
layers, 64x128 images, fp32) with the same seeded weights (carried into the
port by ``state_dict_from_jax``) and the same numpy batches, every draw
switched off: no denoising queries, no GridMask or colour augmentation, and
dropout 0 (flax's ``nn.Dropout`` patched to the identity for the JAX run,
as ``test_torch_train_step.py`` does). The rest of the file holds the
port's loop to itself: multi-step calls, resume and pruning bit for bit.
"""

import copy
import logging
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV
from sparsebev_tpu.parallel import make_mesh_for_batch
from sparsebev_tpu.train import hooks as jhooks
from sparsebev_tpu.train import optim as joptim
from sparsebev_tpu.train.runner import Runner as JaxRunner
from sparsebev_tpu.train.step import (create_train_state as j_create_state,
                                      make_train_step as j_make_train_step)
from sparsebev_tpu.utils import checkpoint_io as jckpt

from sparsebev_tpu_torch.models import layers as tlayers
from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.train import hooks as thooks
from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.train.runner import Runner
from sparsebev_tpu_torch.train.step import (create_train_state,
                                            make_multi_step, make_train_step)
from sparsebev_tpu_torch.utils import checkpoint_io
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax
from sparsebev_tpu_torch.utils.version import VERSION

from test_torch_streaming import PC, make_cameras, noise_tree

torch.set_num_threads(1)

B, T, N = 1, 2, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 32, 16, 2, 4, 4, 2
MAX_GT, NUM_CLASSES = 8, 10
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
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
        mixer_out_points=16),
)
EPOCHS, ITERS = 2, 2
OPT = dict(lr=2e-4, weight_decay=0.01, total_steps=EPOCHS * ITERS,
           warmup_iters=2)
CUSTOM_KEYS = {"backbone": 0.1, "sampling_offset": 0.1}
GRAD_CLIP = 35.0
# step 1: the same weights and batch through two frameworks' fp32 kernels
STEP1_RTOL = 1e-5
# later steps: the updates carry step 1's rounding differences into the
# weights (Adam's g / (|g| + eps) turns an entry within rounding of zero into
# a full step either way); measured up to 6e-6 relative over steps 2-4
LATER_RTOL = 5e-5


def _batches(n, seed=0):
    """``n`` seeded host batches (numpy, as a loader collates them)."""
    rng = np.random.RandomState(seed)
    l2i = np.tile(make_cameras(rng, H, W)[None], (B, T, 1, 1)).reshape(
        B, T * N, 4, 4).astype(np.float32)
    out = []
    for _ in range(n):
        gt_boxes = np.concatenate([
            rng.uniform(-30, 30, (B, MAX_GT, 2)),
            rng.uniform(-2, 1, (B, MAX_GT, 1)),
            rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
            rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
            rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
        gt_mask = np.zeros((B, MAX_GT), bool)
        gt_mask[:, :5] = True
        gt_boxes[~gt_mask] = 0.0
        out.append(dict(
            img=rng.randint(0, 256, (B, T * N, H, W, 3)).astype(np.float32),
            lidar2img=l2i, time_diff=np.asarray([[0.0, 0.5]], np.float32),
            gt_boxes=gt_boxes,
            gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)).astype(
                np.int32),
            gt_mask=gt_mask))
    return out


class Recorder:
    """Every step's metrics and learning rate, as a hook sees them."""

    def __init__(self):
        self.metrics, self.lr, self.steps = [], [], []

    def after_iter(self, runner, metrics):
        self.metrics.append(dict(metrics))
        self.lr.append(runner.current_lr())
        self.steps.append(runner.global_step)


def _port_state(cfg, state_dict=None, seed=0, total_steps=OPT["total_steps"]):
    model = build_detector({"model": copy.deepcopy(cfg)}, device="cpu")
    if state_dict is None:
        random_init_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    opt, sched = toptim.build_optimizer(
        model, lr=OPT["lr"], weight_decay=OPT["weight_decay"],
        total_steps=total_steps, warmup_iters=OPT["warmup_iters"],
        custom_keys=CUSTOM_KEYS,
        frozen_patterns=toptim.vovnet_frozen_patterns(1))
    return create_train_state(model, opt, sched)


def _schedule(total_steps=OPT["total_steps"]):
    return toptim.cosine_warmup_schedule(OPT["lr"], total_steps,
                                         OPT["warmup_iters"])


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX and the port's Runner over the same batches and weights."""
    rng = np.random.RandomState(0)
    loader = _batches(ITERS)
    cfg = copy.deepcopy(MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    b0 = {k: jnp.asarray(v) for k, v in loader[0].items()}
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0)}, b0["img"], b0["lidar2img"],
        b0["time_diff"])
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])

    frozen = joptim.backbone_frozen_patterns(MODEL["img_backbone"],
                                             prefix="backbone")
    tx, schedule = joptim.build_optimizer(
        variables["params"], grad_clip=GRAD_CLIP, custom_keys=CUSTOM_KEYS,
        frozen_patterns=frozen, **OPT)
    step = j_make_train_step(jmodel, NUM_CLASSES, CW, PC, Q,
                             query_denoising=False)
    j_rec = Recorder()
    real_dropout = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x
    try:
        jr = JaxRunner(step, j_create_state(variables, tx),
                       [dict(b) for b in loader],
                       str(tmp_path_factory.mktemp("jax")),
                       total_epochs=EPOCHS, lr_schedule=schedule,
                       hooks=[jhooks.IterTimerHook(), j_rec],
                       mesh=make_mesh_for_batch(1), seed=0)
        jr.run()
    finally:
        fnn.Dropout.__call__ = real_dropout

    state = _port_state(MODEL, sd)
    _no_dropout(state.model)
    t_rec = Recorder()
    tr = Runner(make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=False,
                                grad_clip=GRAD_CLIP),
                state, [dict(b) for b in loader],
                str(tmp_path_factory.mktemp("port")), total_epochs=EPOCHS,
                lr_schedule=_schedule(), hooks=[thooks.IterTimerHook(), t_rec],
                device="cpu", seed=0)
    tr.run()
    return dict(j=j_rec, t=t_rec, j_step=int(jr.global_step),
                t_step=tr.global_step, t_state=state)


def test_runner_learning_rate_follows_jax(both):
    j, t = both["j"], both["t"]
    assert t.steps == j.steps == list(range(1, EPOCHS * ITERS + 1))
    # the JAX schedule evaluates in fp32, the port's in Python floats
    np.testing.assert_allclose(t.lr, j.lr, rtol=1e-6)
    # and the optimizer's own learning rate is the schedule's
    groups = both["t_state"].optimizer.param_groups
    unit = next(g for g in groups if g["lr_mult"] == 1.0)
    np.testing.assert_allclose(unit["lr"], t.lr[-1], rtol=1e-12)


def test_runner_losses_follow_jax(both):
    j, t = both["j"], both["t"]
    assert len(t.metrics) == len(j.metrics) == EPOCHS * ITERS
    keys = {"loss", "grad_norm", "loss_cls", "loss_bbox", "d0.loss_cls",
            "d0.loss_bbox"}
    assert set(t.metrics[0]) == set(j.metrics[0]) == keys
    first_t, first_j = t.metrics[0], j.metrics[0]
    for k in keys:
        np.testing.assert_allclose(first_t[k], first_j[k], rtol=STEP1_RTOL,
                                   err_msg=k)
    for i in range(1, len(j.metrics)):
        for k in ("loss", "loss_cls", "loss_bbox"):
            np.testing.assert_allclose(t.metrics[i][k], j.metrics[i][k],
                                       rtol=LATER_RTOL, err_msg=(i, k))
    # the updates move the loss: the later steps are not step 1 again
    assert t.metrics[2]["loss"] != first_t["loss"]
    assert both["t_step"] == both["j_step"] == EPOCHS * ITERS


# ----------------------------------------------- the port's loop on its own

DRAW_MODEL = copy.deepcopy(MODEL)
DRAW_MODEL["use_grid_mask"] = True
DRAW_MODEL["data_aug"]["img_color_aug"] = True


def _draw_step():
    """A DN-on step: denoising noise, augmentations and dropout all draw."""
    return make_train_step(NUM_CLASSES, CW, PC, Q, dn_groups=2,
                           grad_clip=GRAD_CLIP)


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def test_steps_per_dispatch_equals_single_steps(tmp_path, caplog):
    """Two steps a call over stacked batches, with every draw on, end on
    the same parameter bits as the single steps; the hooks fire once a
    call with the two steps' metrics averaged, and a fifth batch (a
    partial group) is dropped with a log line."""
    loader = _batches(5, seed=1)
    runs = {}
    for k in (1, 2):
        state = _port_state(DRAW_MODEL, seed=3, total_steps=8)
        rec = Recorder()
        data = loader[:4] if k == 1 else loader
        r = Runner(_draw_step(), state, [dict(b) for b in data],
                   str(tmp_path / f"k{k}"), total_epochs=1,
                   lr_schedule=_schedule(8), hooks=[rec], device="cpu",
                   seed=5, steps_per_dispatch=k)
        with caplog.at_level(logging.INFO):
            r.run()
        runs[k] = (_params(state), rec, r)
    (p1, rec1, r1), (p2, rec2, r2) = runs[1], runs[2]
    assert r1.global_step == r2.global_step == 4
    assert r2.iters_per_epoch == 2 and len(rec2.metrics) == 2
    assert len(rec1.metrics) == 4
    for key in p1:
        assert torch.equal(p1[key], p2[key]), key
    for i in range(2):
        for key in ("loss", "grad_norm"):
            pair = [rec1.metrics[2 * i][key], rec1.metrics[2 * i + 1][key]]
            np.testing.assert_allclose(rec2.metrics[i][key], np.mean(pair),
                                       rtol=1e-6)
    assert any("drops a trailing partial group of 1 batch" in m
               for m in caplog.messages)


def test_make_multi_step_stacks_the_metrics():
    state = _port_state(DRAW_MODEL, seed=3, total_steps=8)
    batches = _batches(2, seed=2)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    multi = make_multi_step(_draw_step(), 2)
    _, metrics = multi(state, stacked, torch.Generator().manual_seed(0))
    assert state.step == 2
    assert all(v.shape == (2,) for v in metrics.values())
    assert "loss" in metrics and "loss_cls_dn" in metrics


def _resume_run(tmp_path, split):
    """2 epochs of 2 iterations with no draws, straight through (``split``
    False) or as 1 epoch, a checkpoint, and a fresh Runner (other weights)
    that resumes from it and runs the second."""
    loader = _batches(2, seed=4)
    step = make_train_step(NUM_CLASSES, CW, PC, Q, query_denoising=False,
                           grad_clip=GRAD_CLIP)

    def runner(state, epochs, work_dir, hooks=()):
        _no_dropout(state.model)
        return Runner(step, state, [dict(b) for b in loader], str(work_dir),
                      total_epochs=epochs, lr_schedule=_schedule(),
                      hooks=list(hooks), device="cpu", seed=0)

    if not split:
        r = runner(_port_state(MODEL, seed=6), 2, tmp_path / "straight")
        r.run()
        return r
    work = tmp_path / "split"
    r = runner(_port_state(MODEL, seed=6), 1, work,
               [thooks.CheckpointHook(max_keep_ckpts=1)])
    r.run()
    saved = _params(r.state)
    r2 = runner(_port_state(MODEL, seed=7), 2, work)
    r2.resume(checkpoint_io.latest_checkpoint(str(work)))
    assert r2.global_step == 2 and r2.epoch == 1
    got = _params(r2.state)
    for key in saved:
        assert torch.equal(got[key], saved[key]), key
    r2.run()
    return r2


def test_resume_equals_the_uninterrupted_run(tmp_path):
    straight = _resume_run(tmp_path, split=False)
    resumed = _resume_run(tmp_path, split=True)
    assert straight.global_step == resumed.global_step == 4
    a, b = _params(straight.state), _params(resumed.state)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    sa = straight.state.optimizer.state_dict()["state"]
    sb = resumed.state.optimizer.state_dict()["state"]
    for i in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][name], sb[i][name]), (i, name)
    assert straight.state.scheduler.last_epoch \
        == resumed.state.scheduler.last_epoch == 4


def test_pruning_and_latest_checkpoint_behave_as_in_jax(tmp_path):
    """Save steps 3, 10, 7, 12 with ``max_keep=2`` through both packages:
    the same steps are left and the same one is the latest."""
    state = _port_state(MODEL, seed=0)
    jstate = types.SimpleNamespace(params={"w": np.zeros(2, np.float32)},
                                   batch_stats={}, opt_state={},
                                   step=np.int32(0))
    assert checkpoint_io.latest_checkpoint(str(tmp_path / "none")) is None
    assert jckpt.latest_checkpoint(str(tmp_path / "none")) is None
    for s in (3, 10, 7, 12):
        state.step = s
        jstate.step = np.int32(s)
        checkpoint_io.save_checkpoint(str(tmp_path / "port"), s, state,
                                      max_keep=2)
        jckpt.save_checkpoint(str(tmp_path / "jax"), s, jstate, max_keep=2)
        got = sorted(f for f in os.listdir(tmp_path / "port"))
        want = sorted(os.listdir(tmp_path / "jax"))
        assert [f[:-len(".pth")] for f in got] == want, (s, got, want)
        assert os.path.basename(checkpoint_io.latest_checkpoint(
            str(tmp_path / "port")))[:-len(".pth")] == os.path.basename(
                jckpt.latest_checkpoint(str(tmp_path / "jax")))
    assert want == ["ckpt_10", "ckpt_12"]


def test_resume_restores_the_version_tag(tmp_path):
    state = _port_state(MODEL, seed=0)
    state.step = 5
    old = VERSION.name
    try:
        VERSION.name = "v0.17.1"
        path = checkpoint_io.save_checkpoint(str(tmp_path), 5, state,
                                             extra={"epoch": 3})
        VERSION.name = "v1.0.0"
        r = Runner(_draw_step(), _port_state(MODEL, seed=1), [],
                   str(tmp_path), total_epochs=4, device="cpu")
        r.resume(path)
        assert VERSION.name == "v0.17.1"
        assert r.global_step == 5 and r.epoch == 3
        VERSION.name = "v1.0.0"
        fresh = checkpoint_io.restore_train_state(path,
                                                  _port_state(MODEL, seed=2))
        assert VERSION.name == "v0.17.1" and fresh.step == 5
        want = state.model.state_dict()
        for key, v in fresh.model.state_dict().items():
            assert torch.equal(v, want[key]), key
    finally:
        VERSION.name = old


def _log_line(hook, runner, metrics, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        hook.after_iter(runner, metrics)
    return [r.getMessage() for r in caplog.records]


def test_text_logger_line_equals_the_jax_line(caplog):
    metrics = {"loss": 12.3456789, "grad_norm": 81.5, "loss_cls": 1.25,
               "d0.loss_cls": 3.0, "loss_bbox_dn": 0.125}
    runner = types.SimpleNamespace(
        iter=1, epoch=2, total_epochs=24, iters_per_epoch=3517,
        global_step=7035, log_vars={"time": 0.3125, "data_time": 0.0625},
        current_lr=lambda: 1.5e-4)
    got = _log_line(thooks.TextLoggerHook(interval=1), runner, metrics,
                    caplog)
    want = _log_line(jhooks.TextLoggerHook(interval=1), runner, metrics,
                     caplog)
    assert got == want and len(got) == 1
    assert got[0].startswith("Epoch [3/24][2/3517] lr: 1.500e-04, eta: ")
    assert "d0.loss_cls" not in got[0]
    # off the interval: no line from either
    assert _log_line(thooks.TextLoggerHook(interval=4), runner, metrics,
                     caplog) == []


def test_eval_hook_calls_its_function_at_its_interval():
    seen = []
    hook = thooks.EvalHook(interval=2, eval_fn=lambda st: seen.append(st)
                           or {"mAP": 0.5})
    runner = types.SimpleNamespace(epoch=0, state="S", eval_results={})
    hook.after_epoch(runner)
    assert seen == [] and runner.eval_results == {}
    runner.epoch = 1
    hook.after_epoch(runner)
    assert seen == ["S"] and runner.eval_results == {"mAP": 0.5}


def test_hooks_register_by_name():
    from sparsebev_tpu_torch.registry import HOOKS
    for name in ("IterTimerHook", "TextLoggerHook", "TensorboardLoggerHook",
                 "CheckpointHook", "SamplerSeedHook", "EvalHook"):
        assert name in HOOKS
    hook = HOOKS.build(dict(type="CheckpointHook", max_keep_ckpts=3))
    assert isinstance(hook, thooks.CheckpointHook) and hook.max_keep == 3


def test_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runner(_draw_step(), None, [], "unused", total_epochs=1)
