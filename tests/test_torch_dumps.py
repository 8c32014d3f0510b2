"""The port's decoder dumps and the side tools on the CPU: the ``DUMP``
files of the small r50 model's head (``test_torch_streaming.py``'s model,
fp32, weights from a JAX tree of seeded noise through
``state_dict_from_jax``, one packed pyramid made from the same numpy
features) against the JAX package's ``DUMP`` files stage by stage, the
predictions with dumps on against dumps off, both viz tools writing their
PNGs, the parity dry run writing ``parity.json`` and the loader bench's
rows."""

import copy
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.utils.dump import DUMP as JAX_DUMP

from sparsebev_tpu_torch.data import make_synthetic_dataset
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.tools import (loader_bench, parity,
                                       viz_bbox_predictions,
                                       viz_sample_points)
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax
from sparsebev_tpu_torch.utils.dump import DUMP

from test_torch_cli import SMOKE
from test_torch_streaming import (MODEL, H, L, LAYERS, N, T, W, C, G,
                                  jax_model_and_coder, make_cameras,
                                  noise_tree)

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")

torch.set_num_threads(1)

NAMES = ("sasa_tau", "sample_points_cam", "sample_points_cam_valid_mask",
         "query_bbox", "bbox_pred", "cls_score")
# the head alone on the same packed pyramid, fp32 in both frameworks
DUMP_RTOL = 1e-5


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    rng = np.random.RandomState(0)
    jmodel, _ = jax_model_and_coder()
    layout = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((1, T * N, H, W, 3)),
                              jnp.zeros((1, T * N, 4, 4)), jnp.zeros((1, T)),
                              train=False),
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)})
    variables = {k: noise_tree(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), layout[k]), rng)
        for k in ("params", "batch_stats")}
    model = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    variables["params"]["head"]["init_query_bbox"] = (
        model.pts_bbox_head.init_query_bbox.weight.detach().numpy()
        + variables["params"]["head"]["init_query_bbox"])
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    # T frames of FPN maps, one packed pyramid in both packages
    feats = [rng.randn(1, T * N, (H // 4) >> i, (W // 4) >> i, C)
             .astype(np.float32) for i in range(L)]
    gsplit = MODEL["pts_bbox_head"]["table_gsplit"]
    jpacked = jms.pack_mlvl_feats_grouped([jnp.asarray(f) for f in feats],
                                          N, G, gsplit=gsplit)
    tpacked = tms.pack_mlvl_feats_grouped([torch.from_numpy(f)
                                           for f in feats], N, G,
                                          gsplit=gsplit)
    l2i = np.tile(make_cameras(rng, H, W)[None], (1, T, 1, 1)).reshape(
        1, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)
    root = tmp_path_factory.mktemp("dumps")

    JAX_DUMP.enable(str(root / "jax"))
    try:
        want = jmodel.apply(variables, jpacked, jnp.asarray(l2i),
                            jnp.asarray(td), H, W,
                            method=jmodel.forward_head)
        want = jax.device_get(want)
    finally:
        JAX_DUMP.enabled = False
    args = (torch.from_numpy(l2i), torch.from_numpy(td), H, W)
    with torch.inference_mode():
        off = model.forward_head(tpacked, *args)
        DUMP.enable(str(root / "torch"))
        try:
            on = model.forward_head(tpacked, *args)
        finally:
            DUMP.enabled = False
    return dict(root=root, want=want, on=on, off=off)


@pytest.mark.parametrize("name", NAMES)
def test_dumps_match_jax_stage_by_stage(dumps, name):
    """Every file the JAX decoder writes, under the same name, shape and
    stage, within ``DUMP_RTOL`` of its scale (the valid masks equal)."""
    jdir, tdir = dumps["root"] / "jax", dumps["root"] / "torch"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    valid = []
    for stage in range(LAYERS):
        fname = f"{name}_stage{stage}.npy"
        want, got = np.load(jdir / fname), np.load(tdir / fname)
        assert got.shape == want.shape and got.dtype == np.float32, fname
        if name.endswith("valid_mask"):
            valid.append(want)
            np.testing.assert_array_equal(got, want, err_msg=fname)
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=DUMP_RTOL * scale, err_msg=fname)
    if valid:       # the masks hold points seen and points unseen
        valid = np.stack(valid)
        assert 0 < valid.sum() < valid.size


def test_dumps_change_no_prediction(dumps):
    """With dumps on, every layer classifies (as in JAX, where the returned
    scores are then every layer's): the boxes and the last layer's scores
    are the bits of the run with dumps off, the earlier layers' scores are
    the dumped ones before the sigmoid and JAX's."""
    on, off, want = dumps["on"], dumps["off"], dumps["want"]
    assert torch.equal(on["all_bbox_preds"], off["all_bbox_preds"])
    assert torch.equal(on["all_cls_scores"][-1], off["all_cls_scores"][-1])
    assert bool((off["all_cls_scores"][:-1] == -1e4).all())
    for stage in range(LAYERS):
        dumped = np.load(dumps["root"] / "torch" / f"cls_score_stage{stage}"
                         ".npy")
        np.testing.assert_allclose(
            dumped, torch.sigmoid(on["all_cls_scores"][stage]).numpy(),
            rtol=0, atol=1e-7)
    scale = np.abs(want["all_cls_scores"]).max()
    np.testing.assert_allclose(on["all_cls_scores"].numpy(),
                               want["all_cls_scores"], rtol=0,
                               atol=DUMP_RTOL * scale)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("side_tools_synth")
    return make_synthetic_dataset(str(root), num_samples=2,
                                  sweeps_between=1)


def _png(path):
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n", path
    assert os.path.getsize(path) > 1000, path


def test_viz_sample_points_writes_its_png(synth, tmp_path):
    out = viz_sample_points.main([
        "--config", SMOKE, "--device", "cpu", "--stage", "1",
        "--out-dir", str(tmp_path), "--override",
        f"data.val.ann_file={synth}"])
    assert out == str(tmp_path / "sample_points_stage1.png")
    _png(out)
    assert not DUMP.enabled
    assert os.path.exists(tmp_path / "sample_points_cam_stage1.npy")


def test_viz_bbox_predictions_writes_its_pngs(synth, tmp_path):
    cams, bev = viz_bbox_predictions.main([
        "--config", SMOKE, "--device", "cpu", "--score-thresh", "0.0",
        "--out-dir", str(tmp_path), "--override",
        f"data.val.ann_file={synth}"])
    assert (cams, bev) == (str(tmp_path / "cams_0.png"),
                           str(tmp_path / "bev_0.png"))
    _png(cams)
    _png(bev)


def test_box_corners_match_the_jax_tool():
    """The numpy helpers are the JAX tool's (``tools/
    viz_bbox_predictions.py``), corner for corner."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_viz_bbox", os.path.join(os.path.dirname(SMOKE), os.pardir,
                                     "tools", "viz_bbox_predictions.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    box = np.array([3.0, -4.0, -1.0, 1.9, 4.5, 1.6, 0.7, 0.0, 0.0])
    np.testing.assert_array_equal(viz_bbox_predictions.box_corners(box),
                                  jtool.box_corners(box))
    assert viz_bbox_predictions._EDGES == jtool._EDGES


def test_parity_dry_run_writes_its_report(tmp_path, capsys):
    """``--synthetic`` on the smoke config: the val CLI in a subprocess on
    a synthetic split, the NDS parsed from its log, ``parity.json`` with
    the JAX tool's keys."""
    work = tmp_path / "parity"
    rc = parity.main(["--config", SMOKE, "--device", "cpu", "--synthetic",
                      "--limit", "2", "--expected-nds", "0.5",
                      "--work-dir", str(work)])
    assert rc == 0
    with open(work / "parity.json") as f:
        report = json.load(f)
    assert list(report) == ["nds", "expected", "checkpoint", "work_dir",
                            "diff", "within_noise"]
    assert 0.0 <= report["nds"] <= 1.0
    assert report["expected"] == 0.5 and report["checkpoint"] is None
    assert report["work_dir"] == str(work)
    assert report["diff"] == round(report["nds"] - 0.5, 4)
    assert report["within_noise"] == (abs(report["diff"]) <= 0.3)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == report
    assert os.path.exists(work / "submission.json")


def test_loader_bench_reports_both_decoders(capsys):
    rows = loader_bench.main(["--frames", "1", "--reps", "1"])
    from sparsebev_tpu_torch.data import fastloader
    paths = (["fused_native"] if fastloader.available() else []) \
        + ["eager_pil"]
    assert [r["path"] for r in rows] == paths
    for r in rows:
        assert list(r) == ["path", "jpegs_per_s", "samples_per_s",
                           "ms_per_sample", "host_cores",
                           "fused_worker_threads"]
        assert r["jpegs_per_s"] > 0 and r["samples_per_s"] > 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == rows
