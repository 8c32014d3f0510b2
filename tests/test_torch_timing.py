"""The port's FPS harness and CLI on the CPU: ``inference.make_ring_bench``
against the JAX package's ``make_ring_bench`` (the harness JAX's
``bench.py`` and ``tools/timing.py`` share) on the small r50 model of
``test_torch_streaming.py`` (fp32, group-split L1, weights from a JAX tree
of seeded noise through ``state_dict_from_jax``), and
``sparsebev_tpu_torch.tools.timing.main`` on the smoke config, its JSON
lines parsed."""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import make_ring_bench as jax_ring_bench

from sparsebev_tpu_torch.inference import make_ring_bench
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.tools import timing
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_cli import SMOKE
from test_torch_streaming import (MODEL, H, N, T, W, jax_model_and_coder,
                                  make_cameras, noise_tree)

torch.set_num_threads(1)

ITERS = 3
# the accumulated scores: fp32 through ResNet-50, FPN and the head, the two
# frameworks rounding convolutions and reductions differently
ACC_RTOL = 1e-4


@pytest.fixture(scope="module")
def bench():
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
    tmodel = build_detector({"model": copy.deepcopy(MODEL)}, device="cpu")
    variables["params"]["head"]["init_query_bbox"] = (
        tmodel.pts_bbox_head.init_query_bbox.weight.detach().numpy()
        + variables["params"]["head"]["init_query_bbox"])
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    frame = rng.uniform(0, 255, (1, N, H, W, 3)).astype(np.float32)
    l2i = np.tile(make_cameras(rng, H, W)[None], (1, T, 1, 1)).reshape(
        1, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)

    loop_for, ring = jax_ring_bench(
        jmodel, variables, jnp.asarray(frame), jnp.asarray(l2i),
        jnp.asarray(td), T, H, W)
    jring, jacc = loop_for(ITERS)(variables, ring, jnp.asarray(frame))
    tframe = torch.from_numpy(frame)
    loop_for, ring = make_ring_bench(tmodel, tframe, torch.from_numpy(l2i),
                                     torch.from_numpy(td), T, H, W)
    before = [t.clone() for t in ring]
    tring, tacc = loop_for(ITERS)(ring, tframe)
    return dict(jring=jring, jacc=float(jacc), ring=ring, tring=tring,
                tacc=tacc, before=before)


def test_ring_bench_accumulates_the_scores_of_jax(bench):
    """``ITERS`` samples: the fp32 running sum of every sample's last-layer
    class scores, read back once, within ``ACC_RTOL`` of JAX's."""
    acc = bench["tacc"]
    assert acc.dtype == torch.float32 and acc.dim() == 0
    assert abs(bench["jacc"]) > 1.0
    np.testing.assert_allclose(float(acc), bench["jacc"], rtol=ACC_RTOL)


def test_ring_bench_updates_the_ring_in_place(bench):
    """The ring comes back as the same buffers (JAX donates it), its slots
    rewritten by samples 0..ITERS-1 (slot i mod T), each level within
    ``ACC_RTOL`` of JAX's ring where JAX keeps the level as one table."""
    ring, tring = bench["ring"], bench["tring"]
    assert tring is ring
    for lvl, (got, old) in enumerate(zip(ring, bench["before"])):
        assert not torch.equal(got, old), lvl
        jlevel = bench["jring"][lvl]
        if not hasattr(jlevel, "shape"):
            continue            # JAX's group-split L1 (per-group chunks)
        want = np.asarray(jlevel)
        assert tuple(got.shape) == want.shape, lvl
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ACC_RTOL * scale, err_msg=str(lvl))


def test_timing_cli_prints_the_jax_keys(tmp_path, capsys):
    """``tools.timing.main`` with ``--e2e`` and ``--profile-dir`` on the
    smoke config: three JSON lines with the JAX CLI's keys (the same ones,
    in the same order), which ``main`` also returns, and a profiler trace."""
    got = timing.main(["--config", SMOKE, "--device", "cpu", "--samples",
                       "3", "--warmup", "1", "--e2e", "--e2e-samples", "2",
                       "--profile-dir", str(tmp_path / "prof")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == got
    fps, serial, overlapped = lines
    assert list(fps) == ["metric", "value", "unit"]
    assert fps["metric"] == "streaming_fps" and fps["unit"] == "fps"
    assert fps["value"] > 0
    assert list(serial) == ["e2e_fps", "e2e_ms_per_sample",
                            "host_pipeline_ms", "dispatch_upload_forward_ms",
                            "metric"]
    assert serial["metric"] == "streaming_fps_e2e"
    assert list(overlapped) == ["e2e_fps", "e2e_ms_per_sample",
                                "host_wait_ms", "dispatch_upload_forward_ms",
                                "overlap", "metric"]
    assert overlapped["metric"] == "streaming_fps_e2e_overlapped"
    for line in (serial, overlapped):
        assert line["e2e_fps"] > 0 and line["e2e_ms_per_sample"] > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
