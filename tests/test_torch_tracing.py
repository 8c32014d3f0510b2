"""The port's tracer (``utils/tracing.py``) on a small VoVNet SparseBEV
(V-19-slim-eSE, FPN 64 ch with 5 outputs, a pair-mode level 0, Q=16, T=2,
P=2, 2 decoder layers, 64x128 images, fp32) on the CPU: off, it records
nothing and never enters a profiler range; on, a streaming call and a
training step give their span trees, one request id a call or step; self
time is the duration less what the children cover; and switching it on
changes no bit of the decoded boxes, the losses or the parameters."""

import copy
import types

import numpy as np
import pytest
import torch

from sparsebev_tpu_torch.bbox.nms_free_coder import build_coder
from sparsebev_tpu_torch.inference import StreamingDetector
from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.train.runner import Runner
from sparsebev_tpu_torch.train.step import create_train_state, make_train_step
from sparsebev_tpu_torch.utils import tracing

torch.set_num_threads(1)

B, T, N = 1, 2, 6
H, W = 64, 128
C, Q, P, G, L, LAYERS = 64, 16, 2, 4, 5, 2
MAX_GT, DN_GROUPS, NUM_CLASSES = 8, 2, 10
PC = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
CW = [2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
NORM = dict(mean=[103.530, 116.280, 123.675], std=[57.375, 57.120, 58.395],
            to_rgb=False)
CFG = {"model": dict(
    type="SparseBEV",
    compute_dtype="float32",
    data_aug=dict(img_norm_cfg=NORM, img_pad_cfg=dict(size_divisor=32)),
    img_backbone=dict(type="VoVNet", spec_name="V-19-slim-eSE",
                      out_features=["stage2", "stage3", "stage4", "stage5"],
                      norm_eval=True, frozen_stages=1),
    img_neck=dict(type="FPN", in_channels=[112, 256, 384, 512],
                  out_channels=C, num_outs=L),
    pts_bbox_head=dict(
        type="SparseBEVHead", num_classes=NUM_CLASSES, in_channels=C,
        num_query=Q, num_frames=T, num_points=P, num_layers=LAYERS,
        num_levels=L, code_size=10, pc_range=PC, num_groups=G,
        mixer_out_points=32, table_yfold=(False, True, True, True, True),
        bbox_coder=dict(type="NMSFreeCoder", pc_range=PC, max_num=Q * 10,
                        num_classes=NUM_CLASSES)))}

STREAM = ["stream.infer", "stream.upload", "stream.frame_pass",
          "stream.head", "stream.decode"]
STEP = ["train.step", "train.forward", "train.losses", "train.matcher",
        "train.backward", "train.optimizer"]


def _cameras(rng):
    mats = []
    for i in range(N):
        yaw = 2 * np.pi * i / N
        cy, sy = np.cos(yaw), np.sin(yaw)
        rt = np.eye(4)
        rt[:3, :3] = [[-sy, cy, 0.0], [0.0, 0.0, -1.0], [cy, sy, 0.0]]
        rt[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        k = np.eye(4)
        k[0, 0] = k[1, 1] = W * 0.8
        k[0, 2], k[1, 2] = W / 2, H / 2
        mats.append((k @ rt).astype(np.float32))
    return np.stack(mats)


def _model():
    return random_init_(build_detector(copy.deepcopy(CFG), device="cpu"), 0)


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    yield
    tracing.disable()


def _samples(count=3):
    """Streaming samples whose windows slide by one frame: sample s holds
    frames s and s + 1, so every sample after the first reuses one."""
    rng = np.random.RandomState(0)
    frames = [rng.uniform(0, 255, (1, N, H, W, 3)).astype(np.float32)
              for _ in range(count + 1)]
    l2i = np.tile(_cameras(rng)[None], (1, T, 1, 1)).reshape(1, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5]], np.float32)
    return [(np.concatenate([frames[s + 1], frames[s]], 1), l2i, td,
             [f"f{s + 1}_{v}" for v in range(N)]
             + [f"f{s}_{v}" for v in range(N)]) for s in range(count)]


def _detector(model):
    return StreamingDetector(model, num_frames=T, coder=build_coder(CFG),
                             device="cpu")


def _batch():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (B, T * N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(_cameras(rng)[None], (B, T, 1, 1)).reshape(B, T * N, 4, 4)
    gt_boxes = np.concatenate([
        rng.uniform(-30, 30, (B, MAX_GT, 2)),
        rng.uniform(-2, 1, (B, MAX_GT, 1)),
        rng.uniform(1.0, 5.0, (B, MAX_GT, 3)),
        rng.uniform(-np.pi, np.pi, (B, MAX_GT, 1)),
        rng.uniform(-2, 2, (B, MAX_GT, 2))], -1).astype(np.float32)
    gt_mask = np.zeros((B, MAX_GT), bool)
    gt_mask[:, :5] = True
    gt_boxes[~gt_mask] = 0.0
    return dict(img=img, lidar2img=l2i,
                time_diff=np.asarray([[0.0, 0.5]], np.float32),
                gt_boxes=gt_boxes,
                gt_labels=rng.randint(0, NUM_CLASSES, (B, MAX_GT)),
                gt_mask=gt_mask)


def _train_step():
    """One DN-on step of a fresh model from the same seed through the
    training loop's feed; returns its metrics and the parameters after."""
    model = _model()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    state = create_train_state(model, opt)
    step = make_train_step(NUM_CLASSES, CW, PC, Q, dn_groups=DN_GROUPS)
    batch = Runner.upload(type("Feed", (), {"device": torch.device("cpu")}),
                          _batch())
    _, metrics = step(state, batch, torch.Generator().manual_seed(3))
    return metrics, {k: p.detach().clone()
                     for k, p in model.named_parameters()}


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with tracing off")


def test_off_records_nothing_and_enters_no_profiler_range(model, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert tracing.span("a") is tracing.span("b") is tracing.span("c")
    with tracing.span("a"):
        pass
    det = _detector(model)
    for s in _samples(2):
        det.infer(*s)
    assert tracing.collect() == {}
    _train_step()
    assert tracing.collect() == {}


def test_stream_tree(model):
    det = _detector(model)
    samples = _samples(3)
    tracing.enable()
    det.infer(*samples[0])              # both frames new
    first = tracing.collect()
    for s in samples[1:]:               # one new frame, one cached
        det.infer(*s)
    later = tracing.collect()
    assert set(first) == set(later) == set(STREAM)
    parent = {"stream.infer": [None], **{n: ["stream.infer"]
                                         for n in STREAM[1:]}}
    for table, calls, new in ((first, 1, 2), (later, 2, 2)):
        ids = table["stream.infer"]["requests"]
        assert table["stream.infer"]["count"] == calls == len(ids)
        for name in STREAM:
            assert table[name]["parents"] == parent[name], name
            assert table[name]["requests"] == ids, name
            assert table[name]["device_ms"] is None     # no card here
            assert 0 <= table[name]["self_ms"] <= table[name]["host_ms"]
        assert table["stream.frame_pass"]["count"] == new
        assert table["stream.upload"]["count"] == new
        assert table["stream.head"]["count"] == calls
    assert first["stream.infer"]["requests"][0] < \
        later["stream.infer"]["requests"][0]
    assert det.frames_run == 4 and det.frames_reused == 2


def test_train_tree():
    tracing.enable()
    _train_step()
    table = tracing.collect()
    assert set(table) == set(STEP) | {"train.upload"}
    parent = {"train.step": [None], "train.upload": [None],
              "train.matcher": ["train.losses"],
              **{n: ["train.step"] for n in ("train.forward", "train.losses",
                                             "train.backward",
                                             "train.optimizer")}}
    step_id = table["train.step"]["requests"]
    assert len(step_id) == 1 and table["train.upload"]["requests"] != step_id
    for name in parent:
        assert table[name]["count"] == 1, name
        assert table[name]["parents"] == parent[name], name
    for name in STEP:
        assert table[name]["requests"] == step_id, name
    # the phases lie inside the step: its self time is what they leave
    phases = sum(table[n]["host_ms"] for n in STEP[1:] if n != "train.matcher")
    assert table["train.step"]["self_ms"] == pytest.approx(
        table["train.step"]["host_ms"] - phases, abs=1e-6)
    assert tracing.collect() == {}      # collect clears


def test_self_time_on_a_hand_built_nest(monkeypatch):
    # root 0..100 holds a 10..40 (which holds b 15..25) and c 60..70
    ticks = iter([0, 10, 15, 25, 40, 60, 70, 100])
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(ticks)))
    tracing.enable()
    with tracing.span("root"):
        with tracing.span("a"):
            with tracing.span("b"):
                pass
        with tracing.span("c"):
            pass
    table = tracing.collect()
    got = {n: (s["host_ms"] * 1e6, s["self_ms"] * 1e6)
           for n, s in table.items()}
    assert got == {"root": (100, 100 - 30 - 10), "a": (30, 30 - 10),
                   "b": (10, 10), "c": (10, 10)}
    assert table["b"]["parents"] == ["a"]
    assert table["a"]["parents"] == table["c"]["parents"] == ["root"]


def test_self_time_counts_only_the_covered_part():
    """A child that runs past its parent's end covers only the overlap."""
    root = tracing.Record("root", None, 1, t0=0, t1=100)
    late = tracing.Record("late", root, 1, t0=80, t1=130)
    table = tracing.summarize([late, root])
    assert table["root"]["self_ms"] * 1e6 == pytest.approx(80)
    assert table["late"]["self_ms"] * 1e6 == pytest.approx(50)


def test_tracing_changes_no_bit(model):
    outs = []
    for on in (False, True):
        if on:
            tracing.enable()
        det = _detector(model)
        outs.append([det.infer(*s) for s in _samples(2)])
        outs[-1].append(_train_step())
        tracing.disable()
    (*boxes_off, (m_off, p_off)), (*boxes_on, (m_on, p_on)) = outs
    for a, b in zip(boxes_off, boxes_on):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert set(m_off) == set(m_on)
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    assert set(p_off) == set(p_on) and len(p_off) > 100
    for k in p_off:
        assert torch.equal(p_off[k], p_on[k]), k
