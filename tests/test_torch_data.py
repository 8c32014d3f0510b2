"""The port's host data path against the JAX package's on the CPU: the
synthetic dataset writer, ``compose_lidar2img``, the 3D boxes, every
pipeline step through the dataset (train, test and ``load_online``
pipelines of ``configs/smoke_synthetic*.py``, the future / interleaved sweep
loaders, CPU normalize and pad, the test-time wrapper), ``collate_batch``,
``compute_time_diff``, the sampler's orders, the threaded loader and the
ctypes binding of ``csrc/fastloader.cpp``.

Both packages draw from numpy's global RNG in the same order, so under the
same ``np.random.seed`` before each sample the port's samples equal JAX's
bit for bit (tolerance 0). The one step whose draws cannot agree is the
host photometric distortion (JAX draws threefry keys, the port a
``torch.Generator``): its pixel math is held to JAX's with the JAX draws
injected, within 1e-5 relative (fp32 hue arithmetic).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from sparsebev_tpu import registry as jregistry
from sparsebev_tpu.builder import build_dataloader as j_build_dataloader
from sparsebev_tpu.builder import build_dataset as j_build_dataset
from sparsebev_tpu.config import Config as JConfig
from sparsebev_tpu.data import box3d as jbox3d
from sparsebev_tpu.data import fastloader as jfast
from sparsebev_tpu.data import loader as jloader
from sparsebev_tpu.data import pipelines as jpipe
from sparsebev_tpu.data.synthetic import make_synthetic_dataset as j_make
from sparsebev_tpu.ops.geometry import compose_lidar2img as j_compose

from sparsebev_tpu_torch import registry as tregistry
from sparsebev_tpu_torch.builder import build_dataloader, build_dataset
from sparsebev_tpu_torch.config import Config
from sparsebev_tpu_torch.data import box3d as tbox3d
from sparsebev_tpu_torch.data import fastloader as tfast
from sparsebev_tpu_torch.data import loader as tloader
from sparsebev_tpu_torch.data import pipelines as tpipe
from sparsebev_tpu_torch.data.synthetic import make_synthetic_dataset
from sparsebev_tpu_torch.ops.geometry import compose_lidar2img

from test_torch_losses import _jax_photo_draws

torch.set_num_threads(1)

PHOTO_RTOL, PHOTO_ATOL = 1e-5, 1e-5
SAMPLES = 4


def _infos(ann):
    with open(ann, "rb") as f:
        return pickle.load(f)


def _assert_tree_equal(a, b, path="", root_a="", root_b=""):
    """Nested dicts / lists / arrays equal exactly; strings equal once the
    two roots are taken out."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}", root_a, root_b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]", root_a, root_b)
    elif isinstance(a, str):
        if root_a:
            a, b = a.replace(root_a, "<root>"), b.replace(root_b, "<root>")
        assert a == b, path
    elif isinstance(a, (tbox3d.Boxes3D, jbox3d.Boxes3D)):
        assert a.box_dim == b.box_dim, path
        np.testing.assert_array_equal(a.tensor, b.tensor, err_msg=path)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("kw", [
    dict(num_samples=3, sweeps_between=2, image_hw=(64, 128), seed=0),
    dict(num_samples=2, sweeps_between=7, image_hw=(36, 64), seed=3,
         max_objects=3),
])
def test_synthetic_dataset_matches_jax(tmp_path, kw):
    ra, rb = str(tmp_path / "jax"), str(tmp_path / "port")
    ann_j, ann_t = j_make(ra, **kw), make_synthetic_dataset(rb, **kw)
    assert os.path.basename(ann_j) == os.path.basename(ann_t)
    _assert_tree_equal(_infos(ann_j), _infos(ann_t), "infos", ra, rb)
    names = sorted(os.listdir(os.path.join(ra, "imgs")))
    assert names == sorted(os.listdir(os.path.join(rb, "imgs")))
    assert len(names) == 6 * (1 + (kw["num_samples"] - 1)
                              * (1 + kw["sweeps_between"]))
    for name in names:
        with open(os.path.join(ra, "imgs", name), "rb") as fa, \
                open(os.path.join(rb, "imgs", name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_lidar2img_matches_jax(seed):
    rng = np.random.RandomState(seed)

    def rot():
        q, _ = np.linalg.qr(rng.randn(3, 3))
        return q * np.sign(np.linalg.det(q))

    args = (rng.randn(3) * 10, rot(), rng.randn(3), rot(),
            rng.randn(3) * 10, rot(),
            np.array([[800.0, 0, 640], [0, 800, 360], [0, 0, 1]]))
    want, got = j_compose(*args), compose_lidar2img(*args)
    assert got.dtype == np.float32 and got.shape == (4, 4)
    np.testing.assert_array_equal(got, want)


def test_boxes3d_and_quaternion_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(4)
    np.testing.assert_array_equal(tbox3d.quaternion_to_rotation_matrix(q),
                                  jbox3d.quaternion_to_rotation_matrix(q))
    arr = rng.randn(7, 9).astype(np.float32) * 20
    bj, bt = jbox3d.Boxes3D(arr.copy()), tbox3d.Boxes3D(arr.copy())
    for b in (bj, bt):
        b.rotate(0.3)
        b.scale(1.04)
    np.testing.assert_array_equal(bt.tensor, bj.tensor)
    np.testing.assert_array_equal(bt.gravity_boxes(), bj.gravity_boxes())
    pc = [-30, -30, -5, 30, 30, 3]
    np.testing.assert_array_equal(bt.in_range_bev(pc), bj.in_range_bev(pc))
    np.testing.assert_array_equal(bt[bt.in_range_bev(pc)].tensor,
                                  bj[bj.in_range_bev(pc)].tensor)


def test_registries_match_jax():
    assert sorted(tregistry.PIPELINES.module_dict) == sorted(
        jregistry.PIPELINES.module_dict)
    assert sorted(tregistry.DATASETS.module_dict) == sorted(
        jregistry.DATASETS.module_dict)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data_synth")
    return j_make(str(root), num_samples=SAMPLES, sweeps_between=3,
                  image_hw=(64, 128))


def _loader_step(name):
    return dict(
        future=dict(type="LoadMultiViewImageFromMultiSweepsFuture",
                    prev_sweeps_num=1, next_sweeps_num=1),
        interleave=dict(type="LoadMultiViewImageFromMultiSweepsFutureInterleave",
                        prev_sweeps_num=1, next_sweeps_num=1))[name]


def _pipeline(cfg, name):
    """The named pipeline of the smoke configs, or a variant of their train
    pipeline."""
    train = [dict(p) for p in cfg.train_pipeline]
    test = [dict(p) for p in cfg.test_pipeline]
    if name == "train":
        return train
    if name == "test":
        return test
    if name == "online":
        return [dict(p) for p in cfg.data["val"]["pipeline"]]
    if name == "train_pil":      # both packages decode with PIL
        return [dict(train[0], lazy="never")] + train[1:]
    if name in ("future", "interleave"):
        return [train[0], _loader_step(name)] + train[2:]
    if name in ("future_test", "interleave_test"):
        step = dict(_loader_step(name.split("_")[0]), test_mode=True)
        return [test[0], step] + test[2:]
    if name == "normalize_pad":
        return train[:-2] + [
            dict(type="NormalizeMultiviewImage", **cfg.img_norm_cfg),
            dict(type="PadMultiViewImage", size_divisor=32)] + train[-2:]
    if name == "multiscale":
        return test[:1] + [dict(type="MultiScaleFlipAug3D",
                                transforms=test[1:-1])] + test[-1:]
    raise KeyError(name)


PIPELINES = ("train", "test", "online", "train_pil", "future", "interleave",
             "future_test", "interleave_test", "normalize_pad", "multiscale")


def _datasets(synth, name):
    config = ("configs/smoke_synthetic_online.py" if name == "online"
              else "configs/smoke_synthetic.py")
    out = []
    for cfg_cls, build in ((JConfig, j_build_dataset),
                           (Config, build_dataset)):
        cfg = cfg_cls.fromfile(config)
        data = dict(cfg.data["val" if name == "online" else "train"])
        data.update(ann_file=synth, pipeline=_pipeline(cfg, name))
        out.append(build(data))
    return out


@pytest.mark.parametrize("name", PIPELINES)
def test_samples_match_jax(synth, name):
    """Every sample of the split under the same seed: images, lidar2img,
    timestamps, ground truth, metas, ``ego_frame`` and ``gt_num_pts``."""
    jds, tds = _datasets(synth, name)
    assert len(jds) == len(tds) == SAMPLES
    for i in range(SAMPLES):
        np.random.seed(100 + i)
        want = jds[i]
        np.random.seed(100 + i)
        got = tds[i]
        assert "img" in got and "lidar2img" in got
        _assert_tree_equal(want, got, f"{name}[{i}]")


def test_photometric_step_pixel_math_matches_jax(synth):
    """The host photometric step under the same numpy seed: the port seeds
    its generator with the ``np.random.randint`` where JAX seeds its key;
    with JAX's draws injected the pixels agree within 1e-5 relative."""
    step = dict(type="PhotoMetricDistortionMultiViewImage")
    jstep = jregistry.build(dict(step), jregistry.PIPELINES)
    tstep = tregistry.build(dict(step), tregistry.PIPELINES)
    jds, _ = _datasets(synth, "test")
    for i in range(2):
        np.random.seed(7 + i)
        base = jds[i]
        imgs = [im.copy() for im in base["img"]]
        np.random.seed(40 + i)
        want = jstep(dict(img=[im.copy() for im in imgs]))["img"]
        np.random.seed(40 + i)
        seed = np.random.randint(0, 2 ** 31 - 1)
        got = tstep.apply(dict(img=[im.copy() for im in imgs]),
                          _jax_photo_draws(jax.random.PRNGKey(seed),
                                           len(imgs)))["img"]
        assert len(got) == len(want)
        np.testing.assert_allclose(np.stack(got), np.stack(want),
                                   rtol=PHOTO_RTOL, atol=PHOTO_ATOL)
        assert np.abs(np.stack(want) - np.stack(imgs)).max() > 1.0


def test_photometric_step_draws_from_the_numpy_seed():
    """Without JAX: the step's draws come from the generator seeded by one
    ``np.random.randint``, so the same numpy seed gives the same pixels and
    the global RNG advances by that one draw."""
    step = tpipe.PhotoMetricDistortionMultiViewImage()
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (8, 12, 3)).astype(np.uint8)
            for _ in range(6)]
    outs = []
    for _ in range(2):
        np.random.seed(5)
        outs.append(np.stack(step(dict(img=list(imgs)))["img"]))
        after = np.random.randint(0, 1000)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.random.seed(5)
    seed = np.random.randint(0, 2 ** 31 - 1)
    assert np.random.randint(0, 1000) == after
    want = step.apply(dict(img=list(imgs)), step.draw(6, seed))["img"]
    np.testing.assert_array_equal(outs[0], np.stack(want))
    assert outs[0].dtype == np.float32 and np.isfinite(outs[0]).all()


@pytest.mark.parametrize("max_gt", [3, 8])
def test_collate_and_time_diff_match_jax(synth, max_gt):
    jds, tds = _datasets(synth, "train")
    samples = []
    for ds in (jds, tds):
        np.random.seed(3)
        samples.append([ds[i] for i in range(3)])
    want = jloader.collate_batch(samples[0], max_gt=max_gt)
    got = tloader.collate_batch(samples[1], max_gt=max_gt)
    assert {"img_metas", "gt_num_pts", "ego_frame"} <= set(got)
    assert got["gt_num_pts"].dtype == np.int64
    _assert_tree_equal(want, got, "batch")
    ts = np.random.RandomState(1).rand(18) * 1e3
    np.testing.assert_array_equal(tloader.compute_time_diff(ts),
                                  jloader.compute_time_diff(ts))


@pytest.mark.parametrize("n,shards,shuffle", [
    (10, 1, True), (10, 3, True), (7, 4, False), (5, 2, True)])
def test_sampler_orders_match_jax(n, shards, shuffle):
    for epoch in (0, 3):
        for shard in range(shards):
            js = jloader.ShardedGroupSampler(n, shard, shards, shuffle, seed=9)
            ts = tloader.ShardedGroupSampler(n, shard, shards, shuffle, seed=9)
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert len(ts) == len(js)
            assert list(ts) == list(js)


@pytest.mark.parametrize("name,workers,batch_size,drop_last", [
    ("test", 2, 3, False), ("train", 1, 3, True)])
def test_threaded_loader_batches_match_jax(synth, name, workers,
                                           batch_size, drop_last):
    """``build_dataloader`` over the dataset: the same batches in the same
    order (the train pipeline draws from numpy's global RNG, so it runs on
    one worker, where the draws come in the sampler's order)."""
    jds, tds = _datasets(synth, name)
    out = []
    for ds, build in ((jds, j_build_dataloader), (tds, build_dataloader)):
        loader = build(ds, batch_size=batch_size, num_workers=workers,
                       shuffle=True, seed=2, max_gt=8, drop_last=drop_last)
        loader.sampler.set_epoch(1)
        np.random.seed(11)
        out.append(list(loader))
    assert len(out[1]) == len(out[0]) == (1 if drop_last else 2)
    _assert_tree_equal(out[0], out[1], "batches")


def test_fastloader_binding_matches_jax(synth):
    """The port's ctypes binding finds the same ``csrc/libfastloader.so``;
    where it is built, decode and the fused resize / crop / flip equal the
    JAX binding's, and where it is not both say so."""
    assert tfast.available() == jfast.available()
    assert tfast.LIB_PATH == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
        "libfastloader.so")
    assert tfast.decoder() == ("native" if jfast.available() else "PIL")
    imgs = os.path.join(os.path.dirname(synth), "imgs")
    paths = sorted(os.path.join(imgs, f) for f in os.listdir(imgs))[:4]
    if not jfast.available():
        assert tfast.decode(paths[0]) is None
        assert tfast.load_batch(paths, (96, 48), (4, 2, 80, 40)) is None
        return
    for p in paths:
        np.testing.assert_array_equal(tfast.decode(p), jfast.decode(p))
    for flip in (False, True):
        want = jfast.load_batch(paths, (96, 48), (4, 2, 80, 40), flip)
        got = tfast.load_batch(paths, (96, 48), (4, 2, 80, 40), flip)
        assert got.shape == (4, 40, 80, 3)
        np.testing.assert_array_equal(got, want)
    assert tfast.load_batch(paths + ["/nonexistent.jpg"], (96, 48),
                            (4, 2, 80, 40)) is None
    # the lazy marker's decode path (PIL or native) equals JAX's
    np.testing.assert_array_equal(tpipe._imread_bgr(paths[0]),
                                  jpipe._imread_bgr(paths[0]))
