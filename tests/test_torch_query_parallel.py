"""Query-sharded streaming in the port (``StreamingDetector(query_group=)``,
the JAX detector's ``mesh``) on two gloo ranks in two processes
(``tests/torch_ranks.py``), against the JAX package's single-device
``StreamingDetector`` and the port's unsharded one on the CPU: the sizes of
``tests/test_query_parallel.py``'s fixture (T=4, 64x128 images, FPN 64 ch,
P=2, 2 decoder layers, fp32) with Q=25, so the two ranks hold 13 and 12
queries, six outward-facing cameras and seeded-noise weights, over a
3-sample stream."""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import StreamingDetector as JaxStreaming

from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_split_ring import _jax_model
from test_torch_streaming import ATOL
from test_torch_streaming import MODEL as R50_MODEL
from test_torch_streaming import make_cameras, noise_tree
from torch_ranks import run_ranks, stream_rank

torch.set_num_threads(1)

T, N, H, W, Q = 4, 6, 64, 128, 25
MODEL = copy.deepcopy(R50_MODEL)
MODEL["pts_bbox_head"].update(num_frames=T, num_query=Q)
MODEL["pts_bbox_head"]["bbox_coder"]["max_num"] = Q * 10
# the sharded head against the unsharded one: the same operations on the
# same values, the attention's products over 13 or 12 query rows instead of
# 25 (the CPU's matrix kernels may block them differently), as a share of
# each output's largest entry
SHARD_RTOL = 1e-5


def _stream(rng):
    frames = rng.randint(0, 256, (3, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (1, T, 1, 1)).reshape(
        1, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5, 1.0, 1.5]], np.float32)
    samples = []
    for i in range(3):
        ids = [max(i - k, 0) for k in range(T)]
        names = [f"/data/sweeps/f{j}_cam{v}.jpg" for j in ids
                 for v in range(N)]
        samples.append((frames[i], l2i, td, names))
    return samples


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    samples = _stream(rng)
    jmodel = _jax_model(MODEL)
    img0 = jnp.asarray(np.concatenate([samples[0][0]] * T, axis=1))
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        img0, jnp.asarray(samples[0][1]), jnp.asarray(samples[0][2]))
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    jdet = JaxStreaming(jmodel, variables, num_frames=T)
    want = [jax.device_get(jdet.infer(*s)) for s in samples]

    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    model.load_state_dict(sd, strict=True)
    det = StreamingDetector(model, num_frames=T, cache_size=T, device="cpu")
    plain = [{k: v.numpy() for k, v in det.infer(*s).items()}
             for s in samples]

    work = tmp_path_factory.mktemp("torch_query_parallel")
    torch.save(dict(model=MODEL, state_dict=sd, num_frames=T,
                    samples=samples), os.path.join(work, "stream_inputs.pt"))
    run_ranks(stream_rank, 2, work)
    ranks = [torch.load(os.path.join(work, f"stream_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    return dict(want=want, plain=plain, ranks=ranks)


def test_ranks_split_the_queries_as_tensor_split(runs):
    assert [r["lo_hi"] for r in runs["ranks"]] == [(0, 13), (13, 25)]


def test_every_rank_returns_every_query(runs):
    a, b = (r["outs"] for r in runs["ranks"])
    for x, y in zip(a, b):
        for key in x:
            assert x[key].shape[2] == Q
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_sharded_stream_matches_jax_single_device(runs, sample):
    got, want = runs["ranks"][0]["outs"][sample], runs["want"][sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key][-1], want[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_sharded_stream_matches_the_unsharded_port(runs, sample):
    got, want = runs["ranks"][0]["outs"][sample], runs["plain"][sample]
    for key in want:
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=SHARD_RTOL * scale, err_msg=key)
