"""The port's training and validation CLIs in-process on the CPU
(``--device cpu``, ``configs/smoke_synthetic*.py`` on a synthetic
nuScenes-format dataset written by the port's ``make_synthetic_dataset``):
checkpoints, the code backup, the log, resume, multi-step dispatch, the
training-time ``EvalHook``, offline and ``--online`` evaluation, weights
from a checkpoint or a reference ``.pth``, and the options that are not
ported. One parity test holds the port's ``run_offline_eval`` on a JAX tree
crossed with ``state_dict_from_jax`` to the JAX package's
``run_offline_eval``: the same decoded boxes, scores and labels within 1e-4
at fp32.
"""

import json
import logging
import os
import re

import numpy as np
import pytest
import torch

import jax

from sparsebev_tpu.builder import build_dataloader as j_build_dataloader
from sparsebev_tpu.builder import build_dataset as j_build_dataset
from sparsebev_tpu.builder import build_model as j_build_model
from sparsebev_tpu.config import Config as JConfig
from sparsebev_tpu.evaluation import run_offline_eval as j_run_offline_eval

from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
from sparsebev_tpu_torch.builder import build_dataloader, build_dataset
from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.data import make_synthetic_dataset
from sparsebev_tpu_torch.evaluation import run_offline_eval
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.tools import train, val
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax
from sparsebev_tpu_torch.utils.version import VERSION

from test_torch_streaming import noise_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke_synthetic.py")
SMOKE_ONLINE = os.path.join(REPO, "configs", "smoke_synthetic_online.py")
SAMPLES = 4
# decoded boxes and scores of the two frameworks' fp32 forwards (ResNet-50,
# FPN, 2 decoder layers): relative and absolute
DECODE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _restore_logging_and_version():
    """The CLIs reset the root logger and may restore a checkpoint's
    VERSION tag: put both back after each test."""
    handlers, level = logging.root.handlers[:], logging.root.level
    version = VERSION.name
    yield
    for h in logging.root.handlers:
        if h not in handlers:
            h.close()
    logging.root.handlers[:] = handlers
    logging.root.setLevel(level)
    VERSION.name = version


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_synth")
    return make_synthetic_dataset(str(root), num_samples=SAMPLES,
                                  sweeps_between=2, image_hw=(64, 128))


def _train(synth, work, *extra, overrides=(), epochs=None):
    argv = ["--config", SMOKE, "--work-dir", str(work), "--device", "cpu",
            "--override", f"data.train.ann_file={synth}", *overrides]
    if epochs is not None:
        argv += ["--epochs", str(epochs)]
    return train.main(argv + list(extra))


def _log(work):
    with open(os.path.join(work, "train.log")) as f:
        return f.read()


def _checkpoints(work):
    return sorted(f for f in os.listdir(work) if f.startswith("ckpt_"))


@pytest.fixture(scope="module")
def trained(synth, tmp_path_factory):
    """One epoch of the smoke config (2 steps of batch 2), no val split."""
    work = tmp_path_factory.mktemp("torch_cli_work")
    runner = _train(synth, work)
    for h in logging.root.handlers:
        h.flush()
    return runner, str(work)


def test_train_cli_writes_checkpoint_backup_and_log(trained):
    runner, work = trained
    assert runner.global_step == 2
    assert _checkpoints(work) == ["ckpt_2.pth"]
    assert os.path.isdir(os.path.join(work, "backup", "sparsebev_tpu_torch"))
    log = _log(work)
    assert re.search(r"loss: [\d.]+", log)
    assert "training done at step 2" in log
    assert "Epoch [1/1][2/2]" in log
    assert not runner.eval_results          # no val split: no EvalHook


def test_train_cli_resume_auto_continues_at_the_saved_step(trained, synth,
                                                           tmp_path):
    _, work = trained
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    os.link(os.path.join(work, "ckpt_2.pth"), resumed / "ckpt_2.pth")
    runner = _train(synth, resumed, overrides=["resume_from=auto"],
                    epochs=2)
    log = _log(resumed)
    assert "resumed from" in log and "at step 2 (epoch 1)" in log
    assert "Epoch [1/2]" not in log and "Epoch [2/2][2/2]" in log
    assert runner.global_step == 4
    assert _checkpoints(resumed) == ["ckpt_4.pth"]


def test_train_cli_multi_dispatch_and_eval_hook(synth, tmp_path):
    """steps_per_dispatch=2 (one call of two steps an epoch) with a val
    split: the EvalHook's metrics come back on the runner."""
    runner = _train(synth, tmp_path, overrides=[
        "steps_per_dispatch=2", f"data.val.ann_file={synth}"])
    assert runner.global_step == 2
    log = _log(tmp_path)
    assert "Epoch [1/1][1/1]" in log and "[2/2]" not in log
    assert "eval @ epoch 1" in log
    metrics = runner.eval_results
    assert {"NDS", "mAP", "mATE", "AP_car"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_val_cli_offline_from_the_checkpoint(trained, synth, tmp_path, capsys):
    _, work = trained
    out_json = str(tmp_path / "sub.json")
    out = val.main(["--config", SMOKE, "--device", "cpu",
                    "--weights", os.path.join(work, "ckpt_2.pth"),
                    "--out", out_json,
                    "--override", f"data.val.ann_file={synth}"])
    log = capsys.readouterr().out
    assert "loaded weights from" in log and "(step 2)" in log
    for key in ("NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE",
                "AP_car"):
        assert re.search(rf"{key}: [\d.]+", log), key
    assert set(out["metrics"]) >= {"NDS", "mAP"}
    assert len(out["results"]) == SAMPLES
    assert len(out["sample_ms"]) == SAMPLES - 1
    with open(out_json) as f:
        sub = json.load(f)
    assert sorted(sub["results"]) == sorted(out["results"])


def test_val_cli_online_from_the_checkpoint(trained, synth, capsys):
    """``--online`` on the ``load_online`` pipeline: history frames come
    without pixels, so every one of them must be found in the ring."""
    _, work = trained
    out = val.main(["--config", SMOKE_ONLINE, "--device", "cpu", "--online",
                    "--weights", os.path.join(work, "ckpt_2.pth"),
                    "--override", f"data.val.ann_file={synth}"])
    log = capsys.readouterr().out
    assert re.search(r"NDS: [\d.]+", log) and re.search(r"mAP: [\d.]+", log)
    assert "ring cache:" in log
    assert len(out["results"]) == SAMPLES
    assert out["frames_run"] == SAMPLES
    assert out["frames_reused"] == SAMPLES
    assert len(out["sample_ms"]) == SAMPLES - 1


def test_val_cli_random_init_with_limit(synth, capsys):
    out = val.main(["--config", SMOKE, "--device", "cpu", "--limit", "2",
                    "--batch-size", "2",
                    "--override", f"data.val.ann_file={synth}"])
    assert "evaluating a random-init model" in capsys.readouterr().out
    assert len(out["results"]) == 2
    assert out["metrics"] is not None


def test_val_cli_loads_a_reference_pth(synth, tmp_path):
    """A reference-format ``.pth`` (``state_dict`` under ``backbone.`` /
    ``neck.`` keys, a top-level ``version`` tag) goes through
    ``load_pretrained``, and the tag reaches VERSION before the decode."""
    cfg = Config.fromfile(SMOKE)
    model = build_detector(cfg, device="cpu", seed=3)
    sd = {re.sub(r"^img_(backbone|neck)\.", r"\1.", k): v
          for k, v in model.state_dict().items()}
    path = str(tmp_path / "reference.pth")
    torch.save({"state_dict": sd, "version": "v0.17.1"}, path)
    out = val.main(["--config", SMOKE, "--device", "cpu", "--weights", path,
                    "--limit", "1",
                    "--override", f"data.val.ann_file={synth}"])
    assert VERSION.name == "v0.17.1"
    # the same weights given directly decode the same boxes
    tok, res = next(iter(out["results"].items()))
    dataset = build_dataset(dict(cfg.data["val"], ann_file=synth))
    dataset.data_infos = dataset.data_infos[:1]
    loader = build_dataloader(dataset, 1, num_workers=1, shuffle=False,
                              drop_last=False, max_gt=cfg.max_gt)
    _, want = run_offline_eval(model, build_coder(cfg), dataset, loader)
    np.testing.assert_array_equal(res["bboxes"], want[tok]["bboxes"])


@pytest.mark.parametrize("cli,argv,match", [
    ("train", ["--multihost"], "item 12"),
    ("train", ["--query-shards", "2"], "item 12"),
    ("val", ["--shard-queries"], "item 12"),
])
def test_unported_parallel_options_raise(cli, argv, match):
    main = train.main if cli == "train" else val.main
    with pytest.raises(NotImplementedError, match=match):
        main(["--config", SMOKE, "--device", "cpu"] + argv)


def test_val_online_requires_batch_size_one():
    with pytest.raises(ValueError, match="batch-size 1"):
        val.main(["--config", SMOKE, "--device", "cpu", "--online",
                  "--batch-size", "2"])


@pytest.mark.parametrize("cli", ["train", "val"])
def test_clis_default_to_cuda(cli, synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = train.main if cli == "train" else val.main
    argv = ["--config", SMOKE, "--override", f"data.train.ann_file={synth}",
            f"data.val.ann_file={synth}"]
    if cli == "train":
        argv += ["--work-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_offline_eval_matches_jax_on_crossed_weights(synth):
    """A JAX tree of seeded noise (its layout from ``jax.eval_shape`` of the
    init, the query boxes on the head's grid) through the JAX package's
    ``run_offline_eval`` and, crossed with ``state_dict_from_jax``, through
    the port's, on the same val split with a padded tail batch (3 samples,
    batch 2)."""
    jcfg = JConfig.fromfile(SMOKE)
    jcfg.merge_from_dict({"data.val.ann_file": synth})
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_dict({"data.val.ann_file": synth})
    jds, tds = j_build_dataset(jcfg.data["val"]), build_dataset(cfg.data["val"])
    jds.data_infos, tds.data_infos = jds.data_infos[:3], tds.data_infos[:3]
    jloader = j_build_dataloader(jds, 2, num_workers=1, shuffle=False,
                                 drop_last=False, max_gt=cfg.max_gt)
    tloader = build_dataloader(tds, 2, num_workers=1, shuffle=False,
                               drop_last=False, max_gt=cfg.max_gt)

    jmodel, aux = j_build_model(jcfg)
    batch = next(iter(jloader))
    layout = jax.eval_shape(
        lambda r: jmodel.init(r, batch["img"][:1], batch["lidar2img"][:1],
                              batch["time_diff"][:1], train=False),
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)})
    rng = np.random.RandomState(0)
    variables = {k: noise_tree(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), layout[k]), rng)
        for k in ("params", "batch_stats")}
    model = build_detector(cfg, device="cpu", seed=0)
    variables["params"]["head"]["init_query_bbox"] = (
        model.pts_bbox_head.init_query_bbox.weight.detach().numpy()
        + variables["params"]["head"]["init_query_bbox"])
    jmetrics, want = j_run_offline_eval(jmodel, variables, aux.build_coder(),
                                        jds, jloader)

    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    metrics, got = run_offline_eval(model, build_coder(cfg), tds, tloader)
    assert list(got) == list(want) and len(got) == 3
    for tok in want:
        w, g = want[tok], got[tok]
        assert set(g) == set(w) == {"bboxes", "scores", "labels", "mask"}
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=DECODE_TOL,
                                   atol=DECODE_TOL)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["mask"], w["mask"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=DECODE_TOL,
                                   atol=DECODE_TOL)
    assert set(metrics) == set(jmetrics)
