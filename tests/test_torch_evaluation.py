"""The port's nuScenes evaluator, submission writer and the evaluation
loop's sample feed against the JAX package's on the CPU, on seeded
predictions and ground truth (numpy on both sides, so the metric tables are
compared for equality: tolerance 0), with and without the ego-pose frame and
the ground truth's point counts."""

import json

import numpy as np
import pytest
import torch

from sparsebev_tpu.evaluation import loop as jloop
from sparsebev_tpu.evaluation import metrics as jmetrics
from sparsebev_tpu.evaluation import results as jresults

from sparsebev_tpu_torch.evaluation import loop as tloop
from sparsebev_tpu_torch.evaluation import metrics as tmetrics
from sparsebev_tpu_torch.evaluation import results as tresults

torch.set_num_threads(1)

CLASSES = list(tmetrics.DEFAULT_CLASSES)


def _boxes(rng, n, spread=35.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)),
        rng.uniform(-2, 1, (n, 1)),
        rng.uniform(0.5, 4, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1)),
        rng.uniform(-3, 3, (n, 2)),
    ], -1).astype(np.float32)


def _samples(seed, n_samples=5, with_ego=False, with_pts=False):
    """Seeded (prediction, ground truth) pairs: noisy copies of the ground
    truth with some label swaps, missing and spurious boxes."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(n_samples):
        n = rng.randint(3, 12)
        gt = _boxes(rng, n)
        gl = rng.randint(0, 10, n)
        pred = gt.copy()
        pred[:, :3] += rng.randn(n, 3).astype(np.float32) * 0.8
        pred[:, 3:6] *= rng.uniform(0.8, 1.2, (n, 3)).astype(np.float32)
        pred[:, 6] += rng.randn(n).astype(np.float32) * 0.3
        pred[:, 7:] += rng.randn(n, 2).astype(np.float32)
        pl = np.where(rng.rand(n) < 0.2, rng.randint(0, 10, n), gl)
        extra = _boxes(rng, 4)
        pred = np.concatenate([pred, extra])
        pl = np.concatenate([pl, rng.randint(0, 10, 4)])
        scores = rng.rand(len(pred)).astype(np.float32)
        mask = rng.rand(len(pred)) > 0.1
        kw = {}
        if with_ego:
            a = rng.uniform(-np.pi, np.pi)
            c, si = np.cos(a), np.sin(a)
            kw["ego_frame"] = np.array([[c, -si, 0, rng.uniform(-5, 5)],
                                        [si, c, 0, rng.uniform(-5, 5)],
                                        [0, 0, 1, 1.8]], np.float32)
        if with_pts:
            kw["gt_num_pts"] = rng.choice([-1, 0, 3, 40], n)
        out.append((pred, scores, pl, gt, gl, mask, f"tok{seed}_{s}", kw))
    return out


@pytest.mark.parametrize("with_ego", [False, True])
@pytest.mark.parametrize("with_pts", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_matches_jax(seed, with_ego, with_pts):
    evs = [jmetrics.NuScenesDetectionEvaluator(CLASSES),
           tmetrics.NuScenesDetectionEvaluator(CLASSES)]
    for pred, scores, pl, gt, gl, mask, token, kw in _samples(
            seed, with_ego=with_ego, with_pts=with_pts):
        for ev in evs:
            ev.add_sample(pred, scores, pl, gt, gl, pred_mask=mask,
                          sample_token=token, **kw)
    want, got = evs[0].evaluate(), evs[1].evaluate()
    assert set(got) == set(want)
    assert {"NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE"} <= set(got)
    assert got == want
    assert 0.0 < got["mAP"] < 1.0


def test_evaluator_filters_and_edge_cases_match_jax():
    """Perfect predictions, no predictions, and the range filter off."""
    rng = np.random.RandomState(3)
    gt, gl = _boxes(rng, 8, spread=20), rng.randint(0, 10, 8)
    for filt in (True, False):
        evs = [jmetrics.NuScenesDetectionEvaluator(CLASSES, filt),
               tmetrics.NuScenesDetectionEvaluator(CLASSES, filt)]
        for ev in evs:
            ev.add_sample(gt.copy(), np.full(8, 0.9), gl, gt, gl)
            ev.add_sample(np.zeros((0, 9), np.float32), np.zeros(0),
                          np.zeros(0, int), gt, gl)
        assert evs[1].evaluate() == evs[0].evaluate()
    assert tmetrics.calc_ap is not jmetrics.calc_ap
    assert tmetrics.CLASS_RANGE == jmetrics.CLASS_RANGE


@pytest.mark.parametrize("seed", [0, 1])
def test_submission_matches_jax(tmp_path, seed):
    results = {}
    for pred, scores, pl, _, _, mask, token, _ in _samples(seed):
        results[token] = dict(bboxes=pred, scores=scores, labels=pl,
                              mask=mask)
    want = jresults.format_nusc_submission(results, CLASSES,
                                           str(tmp_path / "j.json"))
    got = tresults.format_nusc_submission(results, CLASSES,
                                          str(tmp_path / "t.json"))
    assert got == want
    with open(tmp_path / "t.json") as ft, open(tmp_path / "j.json") as fj:
        assert json.load(ft) == json.load(fj)
    assert set(got["results"]) == set(results)
    assert sum(len(v) for v in got["results"].values()) == sum(
        int(r["mask"].sum()) for r in results.values())


def test_velocity_attribute_matches_jax():
    for name in CLASSES + ["unknown"]:
        for vx, vy in ((0.0, 0.0), (0.1, 0.1), (0.3, 0.0), (-2.0, 1.0)):
            for thresh in (0.2, 1.0):
                assert tresults.velocity_attribute(name, vx, vy, thresh) == \
                    jresults.velocity_attribute(name, vx, vy, thresh)


@pytest.mark.parametrize("keys", [(), ("ego_frame",), ("gt_num_pts",),
                                  ("ego_frame", "gt_num_pts")])
def test_add_batch_sample_matches_jax(keys):
    """The loop's shared feed (gt_mask slicing, ego frame, point counts) on
    a collated batch with the optional keys present or not."""
    rng = np.random.RandomState(5)
    b, m = 2, 6
    batch = dict(gt_boxes=np.stack([_boxes(rng, m) for _ in range(b)]),
                 gt_labels=rng.randint(0, 10, (b, m)),
                 gt_mask=rng.rand(b, m) > 0.3)
    if "ego_frame" in keys:
        batch["ego_frame"] = np.tile(np.eye(3, 4, dtype=np.float32), (b, 1, 1))
        batch["ego_frame"][:, :2, 3] = rng.uniform(-20, 20, (b, 2))
    if "gt_num_pts" in keys:
        batch["gt_num_pts"] = rng.choice([-1, 0, 5], (b, m))
    evs = [jmetrics.NuScenesDetectionEvaluator(CLASSES),
           tmetrics.NuScenesDetectionEvaluator(CLASSES)]
    for i in range(b):
        res = dict(bboxes=batch["gt_boxes"][i] + 0.3,
                   scores=rng.rand(m).astype(np.float32),
                   labels=batch["gt_labels"][i], mask=np.ones(m, bool))
        jloop.add_batch_sample(evs[0], batch, i, res, f"t{i}")
        tloop.add_batch_sample(evs[1], batch, i, res, f"t{i}")
    assert evs[1].evaluate() == evs[0].evaluate()
    # a batch without ground truth feeds nothing
    tloop.add_batch_sample(evs[1], {}, 0, res, "none")
    assert evs[1]._num_samples == b


def _eval_samples(rng, n, t=2, hw=(4, 4), m=12):
    """``n`` one-sample batches as a loader collates them: pixels that seed
    ``torch_ranks.score_preds``, and ground truth near its boxes."""
    out = []
    for i in range(n):
        k = rng.randint(3, m)
        gt = np.zeros((1, m, 9), np.float32)
        gt[0, :k] = _boxes(rng, k, spread=12.0)
        mask = np.zeros((1, m), bool)
        mask[0, :k] = True
        out.append(dict(
            img_metas=[{"sample_idx": f"tok{i}"}],
            img=rng.randint(0, 256, (1, t * 6) + hw + (3,)).astype(
                np.float32),
            lidar2img=np.tile(np.eye(4, dtype=np.float32), (1, t * 6, 1, 1)),
            time_diff=np.zeros((1, t), np.float32), gt_boxes=gt,
            gt_labels=rng.randint(0, 10, (1, m)), gt_mask=mask))
    return out


def test_offline_eval_over_two_ranks_matches_jax(tmp_path):
    """``run_offline_eval(group=...)`` on two gloo ranks (rank r evaluates
    the split's samples r, r + 2, ..., padded as the sampler pads; rank 0
    gathers) against the JAX loop in one process over batches of 2 with a
    padded tail: the same scores, labels and masks, the boxes within the
    two coders' rounding, and the same metric table. The model is a
    stand-in whose predictions the pixels seed (the same numpy function on
    both sides, through a host callback in JAX)."""
    import jax
    import jax.numpy as jnp

    from sparsebev_tpu.bbox.nms_free_coder import NMSFreeCoder as JaxCoder
    from torch_ranks import eval_rank, run_ranks, score_preds

    rng = np.random.RandomState(11)
    samples = _eval_samples(rng, 5)
    coder = dict(pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
                 post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                 max_num=20, num_classes=10)

    class JaxScoreModel:
        def apply(self, variables, img, lidar2img, time_diff, train=False):
            shapes = {k: jax.ShapeDtypeStruct(v.shape, np.float32)
                      for k, v in score_preds(
                          np.zeros(img.shape, np.float32), None, None)
                      .items()}
            return jax.pure_callback(
                lambda i, l, t: score_preds(np.asarray(i), l, t), shapes,
                img, lidar2img, time_diff)

    class Split:
        classes = CLASSES

        def __len__(self):
            return len(samples)

    def collate(group):
        out = {k: np.concatenate([s[k] for s in group])
               for k in group[0] if k != "img_metas"}
        out["img_metas"] = [m for s in group for m in s["img_metas"]]
        return out

    jbatches = [collate(samples[i:i + 2]) for i in range(0, 5, 2)]
    want_metrics, want = jloop.run_offline_eval(
        JaxScoreModel(), {}, JaxCoder(**coder), Split(), jbatches)

    torch.save(dict(samples=samples, coder=coder, classes=CLASSES),
               tmp_path / "eval_inputs.pt")
    run_ranks(eval_rank, 2, tmp_path)
    out = torch.load(tmp_path / "eval_out.pt", weights_only=False)
    assert list(out["results"]) == list(want) == [f"tok{i}"
                                                  for i in range(5)]
    for tok, w in want.items():
        got = out["results"][tok]
        for k in ("scores", "labels", "mask"):
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
        # the two coders' box decodes (exp, atan2) round differently
        np.testing.assert_allclose(got["bboxes"], w["bboxes"], rtol=1e-6,
                                   atol=1e-6)
    assert out["metrics"] == want_metrics
    assert want_metrics["mAP"] > 0.0
