"""fp8 streaming rings (``table_fp8``) in the port against the JAX package on
the CPU: the e4m3 ring write (clip to +-448 in fp32, then round to nearest
even) bit for bit, ``ring_table_dtypes``, the plain sampling over mixed e4m3 /
bf16 rings (y-fold, pair and group-split levels) bit for bit against jitted
JAX over rings filled from the same numpy features, the pre-quantized
relation of JAX's ``test_ring_fp8_matches_prequantized``, a 3-sample stream
of the small r50 model with an fp8 L0 ring against JAX's
``StreamingDetector``, and the port's ``fp8_drift`` tool."""

import copy
import importlib
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import StreamingDetector as JaxStreaming
from sparsebev_tpu.inference import ring_table_dtypes as jax_ring_dtypes
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV

from sparsebev_tpu_torch import inference
from sparsebev_tpu_torch.data import make_synthetic_dataset
from sparsebev_tpu_torch.inference import StreamingDetector, ring_table_dtypes
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.models.head import SparseBEVHead, check_table_options
from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.tools import fp8_drift, val
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_streaming import MODEL as R50_MODEL
from test_torch_streaming import _stream, noise_tree

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")

torch.set_num_threads(1)

N, C, G = 6, 16, 2
E4M3 = torch.float8_e4m3fn
# e4m3 edges: the largest finite value and values past it (JAX: NaN without
# the clip; torch on the CPU saturates), halfway points that round to even,
# the subnormals (2^-9 .. 7 * 2^-9) and values that round into them or to 0
EDGES = np.array([447.9, -447.9, 448.0, 464.0, -464.0, 480.0, -480.0, 1000.0,
                  -1000.0, 1e30, -1e30, 2.0 ** -9, -2.0 ** -9, 3 * 2.0 ** -9,
                  7 * 2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -9, 2.0 ** -11,
                  -2.5 * 2.0 ** -9, 9.0, 9.5, 10.5, 17.0, 0.0, -0.0],
                 np.float32)


def _np(t):
    return t.detach().float().numpy()


def _bits(t):
    return t.view(torch.uint8).numpy() if t.dtype == E4M3 \
        else t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        .numpy()


def _feats(rng, t, levels, edges=False):
    feats = [(rng.randn(1, t * N, h, w, C) * 4).astype(np.float32)
             for h, w in levels]
    if edges:
        flat = feats[0].reshape(-1)
        flat[:EDGES.size] = EDGES
        flat[-EDGES.size:] = EDGES[::-1]
    return feats


def _frame_j(feats, i, dtype, yfold):
    return jms.pack_mlvl_feats_grouped(
        [jnp.asarray(f[:, i * N:(i + 1) * N], dtype) for f in feats], N, G,
        yfold=yfold)


def _frame_t(feats, i, dtype, yfold):
    return tms.pack_mlvl_feats_grouped(
        [torch.from_numpy(f[:, i * N:(i + 1) * N]).to(getattr(torch, dtype))
         for f in feats], N, G, yfold=yfold)


def _rings(feats, t, dtype, fp8, yfold, gsplit, slots_of_t):
    """A ring of ``t`` slots in both packages, level dtypes e4m3 where
    ``fp8`` marks them, filled frame by frame with ``ring_update``; returns
    the two ring views over ``slots_of_t``."""
    jdt = [jnp.float8_e4m3fn if f else jnp.dtype(dtype) for f in fp8]
    tdt = [E4M3 if f else getattr(torch, dtype) for f in fp8]
    jf0 = _frame_j(feats, 0, dtype, yfold)
    jring = jms.ring_init(jf0, t, tuple(jdt), gsplit=gsplit)
    tf0 = _frame_t(feats, 0, dtype, yfold)
    tring = tms.ring_init(tf0, t, tdt)
    for i in range(t):
        jring = jms.ring_update(jring, _frame_j(feats, i, dtype, yfold),
                                jnp.int32(i))
        tms.ring_update(tring, _frame_t(feats, i, dtype, yfold), i)
    jview = jms.ring_packed(jring, jnp.asarray(slots_of_t, jnp.int32),
                            len(slots_of_t), jf0)
    tview = tms.ring_packed(tring, torch.tensor(slots_of_t),
                            len(slots_of_t), tf0.meta(gsplit=gsplit))
    return jring, tring, jview, tview


# ------------------------------------------------------------ ring write --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("yfold", [True, False])
def test_ring_update_e4m3_cast_matches_jax_bitwise(dtype, yfold):
    rng = np.random.RandomState(1)
    levels = [(4, 6), (2, 3)]
    feats = _feats(rng, 2, levels, edges=True)
    fp8 = (True, False)
    jring, tring, _, _ = _rings(feats, 2, dtype, fp8, (yfold, True), False,
                                [1, 0])
    assert tring[0].dtype == E4M3 and tring[1].dtype == getattr(torch, dtype)
    assert not torch.isnan(tring[0].float()).any()
    np.testing.assert_array_equal(
        tring[0].view(torch.uint8).numpy(),
        np.asarray(jring[0]).view(np.uint8))
    np.testing.assert_array_equal(_np(tring[1]),
                                  np.asarray(jring[1]).astype(np.float32))
    # every edge landed where JAX puts it: +-448 for everything past it
    vals = tring[0].float().numpy().reshape(-1)
    assert np.abs(vals).max() == 448.0
    assert (np.abs(vals) == 448.0).sum() >= 2 * 9


def test_ring_update_casts_as_jax_on_bare_edges():
    """The clip and cast alone, on every edge value (no pack around it)."""
    jfr = types.SimpleNamespace(batch=1, num_groups=1,
                                tables=(jnp.asarray(EDGES.reshape(-1, 1, 1)),))
    jring = jms.ring_update((jnp.zeros((EDGES.size, 1, 1),
                                       jnp.float8_e4m3fn),), jfr, 0)
    tfr = types.SimpleNamespace(batch=1, num_groups=1,
                                tables=(torch.from_numpy(EDGES).reshape(-1, 1,
                                                                        1),))
    tring = tms.ring_update((torch.zeros((EDGES.size, 1, 1), dtype=E4M3),),
                            tfr, 0)
    np.testing.assert_array_equal(tring[0].view(torch.uint8).numpy(),
                                  np.asarray(jring[0]).view(np.uint8))
    assert not torch.isnan(tring[0].float()).any()


# ------------------------------------------------------------ ring dtypes --

@pytest.mark.parametrize("spec", [True, False, (True, False, False, False),
                                  (False, True, False, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_table_dtypes_match_jax(spec, dtype):
    levels = [(8, 16), (4, 8), (2, 4), (1, 2)]
    head = SparseBEVHead(num_classes=10, in_channels=32, num_query=4,
                         num_frames=2, num_points=2, num_layers=1,
                         num_levels=4, pc_range=[-51.2, -51.2, -5.0, 51.2,
                                                 51.2, 3.0], num_groups=2,
                         mixer_out_points=8, table_fp8=spec)
    tfp = types.SimpleNamespace(level_shapes=levels, tables=(
        torch.zeros(1, dtype=getattr(torch, dtype)),))
    jfp = types.SimpleNamespace(level_shapes=levels, tables=(
        jnp.zeros(1, dtype),))
    got = ring_table_dtypes(types.SimpleNamespace(pts_bbox_head=head), tfp)
    want = jax_ring_dtypes(types.SimpleNamespace(
        pts_bbox_head={"table_fp8": spec}), jfp)
    assert [str(d).replace("torch.", "") for d in got] == \
        [jnp.dtype(d).name for d in want]


def test_table_fp8_needs_one_flag_a_level():
    with pytest.raises(ValueError, match="one entry per level"):
        check_table_options(4, table_fp8=(True, False))


def test_table_split_still_raises_naming_its_roadmap_entry():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        check_table_options(4, table_split=2)
    with pytest.raises(NotImplementedError, match="table_split"):
        check_table_options(4, table_fp8=True, table_split=(1, 2, 1, 1))


# ------------------------------------------------ plain sampling over rings --

def _locations(rng, q, s, p, levels):
    loc = np.stack([rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.uniform(-0.15, 1.15, (q, s, p)),
                    rng.randint(0, N, (q, s, p)) / (N - 1)], -1)
    h0, w0 = levels[0]
    loc[0, :, 0, :2] = (-0.3 / (w0 - 1), 0.5)          # shifted window
    loc[1, :, 0, :2] = (0.5, (h0 - 1.5) / (h0 - 1))    # row ry+1 = H-1
    loc[2, :, 0, :2] = (1.0, 1.0)
    return loc.astype(np.float32)


CASES = {
    # level 0 e4m3 (y-fold): fp32 output, every level's fold unrounded
    "e4m3_l0": dict(fp8=(True, False, False), yfold=(True,) * 3,
                    gsplit=False, out="float32"),
    # a later level e4m3: bf16 output
    "e4m3_l1": dict(fp8=(False, True, False), yfold=(True,) * 3,
                    gsplit=False, out="bfloat16"),
    # a pair-mode e4m3 level 0 (the vov99 layout) in the unsplit order
    "e4m3_pair_l0": dict(fp8=(True, False, False), yfold=(False, True, True),
                         gsplit=False, out="float32"),
    # a group-split ring: the pair level's group-major order, e4m3 L0
    "e4m3_pair_l0_gsplit": dict(fp8=(True, False, False),
                                yfold=(False, True, True),
                                gsplit=(False, False, True), out="float32"),
    # a group-split e4m3 level beside bf16 ones
    "e4m3_gsplit_level": dict(fp8=(False, True, False), yfold=(True,) * 3,
                              gsplit=(False, True, False), out="bfloat16"),
}


# the levels of the exact-arithmetic inputs: W - 1 and H - 1 powers of two
DYADIC_LEVELS = [(9, 9), (5, 5), (3, 3)]


def _dyadic_inputs(rng, q, s, p, t_slots):
    """Inputs on which every product and sum of the fold is exact in fp32:
    features k / 2 with |k| <= 8 (e4m3 and bf16 values alike), points on a
    1/64 grid (pixel weights on a 1/32 grid at worst), level weights on a
    1/4 grid. Jitted XLA contracts fp32 multiply-adds into FMAs on the CPU
    (the fp32 fold of an fp32 accumulator); on these inputs an FMA rounds
    nothing, so the fp32 outputs are held bit for bit too."""
    feats = [(rng.randint(-8, 9, (1, t_slots * N, h, w, C)) / 2)
             .astype(np.float32) for h, w in DYADIC_LEVELS]
    loc = np.stack([rng.randint(-8, 73, (q, s, p)) / 64,
                    rng.randint(-8, 73, (q, s, p)) / 64,
                    rng.randint(0, N, (q, s, p)) / (N - 1)], -1)
    loc = loc.astype(np.float32)
    sw = (rng.randint(0, 5, (q, s, p, len(DYADIC_LEVELS))) / 4).astype(
        np.float32)
    return feats, loc, sw


@pytest.mark.parametrize("inputs", ["random", "dyadic"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mixed_ring_sampling_matches_jax(case, inputs):
    """bf16 outputs bit for bit on any inputs; fp32 outputs (an e4m3 level
    0) bit for bit where the fold is exact in fp32 (``_dyadic_inputs``), and
    within 2e-7 of the output scale on random inputs, where jitted XLA's
    FMAs round once where the port rounds twice."""
    spec = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    t_slots, slots_of_t = 3, [2, 0, 1]
    q, s, p = 9, len(slots_of_t) * G, 3
    if inputs == "dyadic":
        feats, loc, sw = _dyadic_inputs(rng, q, s, p, t_slots)
    else:
        levels = [(6, 10), (3, 5), (2, 3)]
        feats = _feats(rng, t_slots, levels)
        loc = _locations(rng, q, s, p, levels)
        sw = rng.rand(q, s, p, len(levels)).astype(np.float32)
    _, _, jview, tview = _rings(feats, t_slots, "bfloat16", spec["fp8"],
                                spec["yfold"], spec["gsplit"], slots_of_t)
    want = jax.jit(lambda r: jms.msmv_sampling(
        r, jnp.asarray(loc), jnp.asarray(sw), qmajor=True))(jview)
    got = tms.msmv_sampling(tview, torch.from_numpy(loc), torch.from_numpy(sw))
    assert str(got.dtype) == f"torch.{spec['out']}"
    assert jnp.dtype(want.dtype).name == spec["out"]
    assert tms.table_acc_dtype(tview) == got.dtype
    assert torch.count_nonzero(got) > got.numel() // 2
    want = np.asarray(want)
    if spec["out"] == "float32" and inputs == "random":
        scale = np.abs(want).max()
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-7 * scale)
        return
    np.testing.assert_array_equal(_bits(got), want.view(
        np.int16 if want.dtype == jnp.bfloat16 else np.int32))


def test_ring_fp8_matches_prequantized():
    """JAX's ``test_ring_fp8_matches_prequantized`` through the port: an
    e4m3 L0 ring samples as a bf16 ring whose L0 values were rounded to
    e4m3 first; only the accumulation dtype (fp32 against bf16) differs."""
    rng = np.random.RandomState(7)
    t, q, p = 3, 5, 4
    levels = [(8, 12), (4, 6)]
    feats = [rng.randn(1, t * N, h, w, C).astype(np.float32)
             for h, w in levels]
    loc = rng.rand(q, t * G, p, 3).astype(np.float32)
    loc[..., 2] = rng.randint(0, N, loc.shape[:-1]) / (N - 1)
    sw = rng.rand(q, t * G, p, len(levels)).astype(np.float32)

    def fill(dtypes, fns):
        fps = [tms.pack_mlvl_feats_grouped(
            [fn(torch.from_numpy(f[:, i * N:(i + 1) * N]))
             for fn, f in zip(fns, feats)], N, G) for i in range(t)]
        ring = tms.ring_init(fps[0], t, dtypes)
        for i, fp in enumerate(fps):
            tms.ring_update(ring, fp, i)
        return tms.msmv_sampling(tms.ring_packed(
            ring, torch.arange(t), t, fps[0].meta()),
            torch.from_numpy(loc), torch.from_numpy(sw)).float()

    ident = lambda x: x                                       # noqa: E731
    prequant = lambda x: x.to(E4M3).to(torch.bfloat16)        # noqa: E731
    got = fill((E4M3, torch.bfloat16), (ident, ident))
    want = fill(torch.bfloat16, (prequant, ident))
    exact = fill(torch.bfloat16, (ident, ident))
    assert (want - exact).abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_e4m3_cuda_tables_never_reach_the_plain_version():
    """An e4m3 ring off the CPU goes to the kernel or raises."""
    rng = np.random.RandomState(3)
    levels = [(4, 6)]
    feats = _feats(rng, 1, levels)
    fp = _frame_t(feats, 0, "bfloat16", (True,))
    ring = tms.ring_init(fp, 1, (E4M3,))
    meta = tms.ring_packed(tuple(t.to("meta") for t in ring),
                           torch.arange(1), 1, fp.meta())
    loc = torch.zeros((2, G, 2, 3), device="meta")
    sw = torch.zeros((2, G, 2, 1), device="meta")
    before = tms.msmv_sampling.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tms.msmv_sampling(meta, loc, sw)
    assert tms.msmv_sampling.launches == before


# ------------------------------------------------------------- the stream --

T, H, W = 2, 32, 64
FP8_MODEL = copy.deepcopy(R50_MODEL)
FP8_MODEL["pts_bbox_head"].update(table_yfold=(True,) * 4,
                                  table_fp8=(True, False, False, False))
ATOL = 2e-3      # as tests/test_torch_streaming.py


@pytest.fixture(scope="module")
def fp8_stream():
    rng = np.random.RandomState(0)
    frames, samples = _stream(rng)
    cfg = copy.deepcopy(FP8_MODEL)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    cfg["pts_bbox_head"].pop("bbox_coder")
    jmodel = JaxSparseBEV(compute_dtype=jnp.float32, **cfg)
    img0 = jnp.asarray(np.concatenate([frames[0]] * T, axis=1))
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        img0, jnp.asarray(samples[0][1]), jnp.asarray(samples[0][2]))
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    tmodel = build_detector({"model": copy.deepcopy(FP8_MODEL)}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables["params"],
                                               variables["batch_stats"]),
                           strict=True)
    jdet = JaxStreaming(jmodel, variables, num_frames=T, cache_size=T)
    tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                             device="cpu")
    outs = [(jax.device_get(jdet.infer(*s)),
             {k: v.numpy() for k, v in tdet.infer(*s).items()})
            for s in samples]
    return jdet, tdet, outs


@pytest.mark.parametrize("sample", [0, 1, 2])
def test_fp8_stream_matches_jax(fp8_stream, sample):
    _, _, outs = fp8_stream
    jp, tp = outs[sample]
    for key in ("all_cls_scores", "all_bbox_preds"):
        assert tp[key].shape == jp[key].shape
        np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                   atol=ATOL, err_msg=key)


def test_fp8_stream_ring_matches_jax(fp8_stream):
    jdet, tdet, _ = fp8_stream
    assert [t.dtype for t in tdet.ring] == [E4M3] + [torch.float32] * 3
    assert list(tdet.slot_of_key.items()) == list(jdet.slot_of_key.items())
    # level 0 in e4m3 from fp32 frames that agree to rounding: almost every
    # entry is bit-equal, the rest one e4m3 step apart
    got, want = _np(tdet.ring[0]), np.asarray(jdet.ring[0]).astype(np.float32)
    assert (got == want).mean() > 0.99
    np.testing.assert_allclose(got, want, rtol=2 ** -3, atol=2e-3)


# ------------------------------------------------------------ the tool --

# the keys of the JAX tool's report (tools/fp8_drift.py): the L0 feature
# error and, for each drift, its mean, 99th percentile and maximum
DRIFT_KEYS = ("d_center_m", "d_size_m", "d_yaw_rad", "d_score", "d_vel_ms")
JAX_REPORT_KEYS = {"metric", "config", "samples", "l0_feature_rel_err_mean",
                   "l0_feature_rel_err_max"} | {
    f"{k}_{s}" for k in DRIFT_KEYS for s in ("mean", "p99", "max")}


def test_fp8_drift_tool_reports_every_jax_key(tmp_path, capsys):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = tmp_path / "tiny_fp8.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(repo, 'configs', 'smoke_synthetic.py')!r}]\n"
        "model = dict(pts_bbox_head=dict(num_query=4, num_layers=1))\n")
    report = fp8_drift.main(["--config", str(cfg), "--samples", "2",
                             "--seed", "3", "--device", "cpu"])
    assert set(report) == JAX_REPORT_KEYS
    assert report["samples"] == 2 and report["metric"] == "fp8l0_drift"
    assert 0 < report["l0_feature_rel_err_mean"] < 0.1
    assert all(np.isfinite(v) for k, v in report.items()
               if k not in ("metric", "config"))
    assert '"fp8l0_drift"' in capsys.readouterr().out


def test_val_cli_online_streams_an_e4m3_ring(tmp_path, monkeypatch):
    """``--online`` builds its ring through ``StreamingDetector``: with
    ``table_fp8`` on level 0 that ring level is e4m3, and the boxes move
    off the exact ring's."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ann = make_synthetic_dataset(str(tmp_path), num_samples=2,
                                 sweeps_between=1, image_hw=(64, 128))
    dtypes = []
    ring_init = inference.ring_init

    def record(fp, slots, dts=None):
        dtypes.append(tuple(dts))
        return ring_init(fp, slots, dts)

    monkeypatch.setattr(inference, "ring_init", record)
    argv = ["--config", os.path.join(repo, "configs", "smoke_synthetic.py"),
            "--device", "cpu", "--online", "--override",
            f"data.val.ann_file={ann}"]
    exact = val.main(argv)
    fp8 = val.main(argv + ["model.pts_bbox_head.table_fp8="
                           "[True,False,False,False]"])
    assert dtypes == [(torch.float32,) * 4,
                      (E4M3,) + (torch.float32,) * 3]
    assert sorted(fp8["results"]) == sorted(exact["results"])
    assert fp8["frames_run"] == exact["frames_run"] > 0
    moved = False
    for tok, res in fp8["results"].items():
        assert np.isfinite(res["bboxes"]).all()
        moved |= not np.array_equal(res["bboxes"],
                                    exact["results"][tok]["bboxes"])
    assert moved
