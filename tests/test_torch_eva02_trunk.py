"""The EVA02 trunk's construction, spans and counters on the CPU
(``sparsebev_tpu_torch/models/eva02.py``, ``ops/eva_attention.py``).

The small EVA02: embed 64, 4 heads of 16, one period of the published
pattern (blocks 0 and 1 windowed, block 2 global), 64x160 images (a 4x10
token grid in windows of 4x4 tokens, padded to 4x12: 3 windows a view),
the pyramid at all four scales with the top block. Its RoPE tables are made
from the numpy tables on the device at first use, so they are neither
parameters nor buffers, and a model built on ``meta`` and given storage by
``to_empty`` computes what a model built on the CPU computes."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from sparsebev_tpu_torch.models import eva02 as teva
from sparsebev_tpu_torch.ops import eva_attention as tatt
from sparsebev_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_HW = (64, 160)
VIEWS = 6
KW = dict(img_size=256, real_img_size=IMG_HW, patch_size=16, embed_dim=64,
          depth=3, num_heads=4, window_size=4, window_block_indexes=(0, 1),
          fpn_out_channels=32, fpn_scale_factors=(4.0, 2.0, 1.0, 0.5),
          fpn_top_block=True, pretrain_img_size=32)
GRID = (IMG_HW[0] // 16, IMG_HW[1] // 16)                  # 4 x 10 tokens
PADDED = (4, 12)                                            # 3 windows


def _seeded(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            scale = 0.1 if p.dim() < 2 else p[0].numel() ** -0.5
            shift = 1.0 if p.dim() == 1 and name.endswith(".weight") else 0.0
            p.copy_(torch.randn(p.shape, generator=gen) * scale + shift)
    return model


def _images(seed=1, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    img = torch.randn(VIEWS, *IMG_HW, 3, generator=gen)
    return img.to(dtype).permute(0, 3, 1, 2)        # NCHW view, as SparseBEV


@pytest.mark.parametrize("name", ["win", "glb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_tables_are_the_numpy_tables(name, dtype):
    vit = teva.EVA02(**KW).net
    hd = KW["embed_dim"] // KW["num_heads"]
    if name == "win":
        want = teva.build_rope_tables(hd, 16, KW["window_size"])
    else:
        want = teva.build_rope_tables(hd, 16, KW["img_size"] // 16,
                                      real_img_size=GRID)
    got = vit.rope(name, torch.device("cpu"), dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(g, torch.from_numpy(w).to(dtype))
    assert vit.rope(name, "cpu", dtype)[0] is got[0]      # made once
    names = {n for n, _ in vit.named_buffers()} | set(vit.state_dict())
    assert not any("rope" in n for n in names)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_meta_built_model_matches_a_cpu_built_one(dtype):
    """Built on ``meta``, given storage by ``to_empty`` and loaded with a
    CPU-built model's state: the same outputs bit for bit, and every
    parameter and buffer comes from the state dict."""
    cpu = _seeded(teva.EVA02(**KW, dtype=dtype))
    with torch.device("meta"):
        meta = teva.EVA02(**KW, dtype=dtype)
    meta = meta.to_empty(device="cpu")
    meta.load_state_dict(cpu.state_dict(), strict=True)
    state = set(meta.state_dict())
    assert {n for n, _ in meta.named_parameters()} <= state
    assert {n for n, _ in meta.named_buffers()} <= state
    x = _images(dtype=dtype or torch.float32)
    with torch.no_grad():
        want, got = cpu(x), meta(x)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _weights_module():
    path = os.path.join(ROOT, "benchmark", "harness", "weights.py")
    spec = importlib.util.spec_from_file_location("bench_weights", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_builds_through_the_benchmarks_meta_build():
    """``benchmark/harness/weights.py::build_on_device`` builds on
    ``meta``, calls ``to_empty`` and refuses any parameter or buffer the
    state dict does not fill: the detector with a small EVA02 passes, and
    its trunk uses the RoPE tables a CPU-built one uses."""
    from sparsebev_tpu_torch.models.detector import SparseBEV
    weights = _weights_module()
    head = dict(num_classes=10, in_channels=32, num_query=16, num_frames=2,
                num_points=8, num_layers=1, num_levels=5, code_size=10,
                pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
                table_yfold=(False, True, True, True, True))

    def make():
        return SparseBEV(img_backbone=dict(type="EVA02", **KW),
                         pts_bbox_head=head, compute_dtype=torch.bfloat16)

    model = weights.build_on_device(torch, make, 7, torch.device("cpu"))
    vit = model.img_backbone.net
    assert model.img_backbone.dtype == torch.bfloat16
    for name in ("win", "glb"):
        got = vit.rope(name, "cpu", torch.float32)
        want = teva.EVA02(**KW).net.rope(name, "cpu", torch.float32)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        feats = model.extract_img_feat(torch.rand(VIEWS, *IMG_HW, 3) * 255)
    assert [f.shape[1:3] for f in feats] == [
        (16, 40), (8, 20), (4, 10), (2, 5), (1, 3)]
    assert all(bool(torch.isfinite(f.float()).all()) for f in feats)


@pytest.fixture
def tracer():
    tracing.disable()
    yield tracing
    tracing.disable()


def test_spans_of_one_frame(tracer):
    """One frame through a one-period trunk: two ``eva02.window_block``
    spans, one ``eva02.global_block`` and one ``eva02.pyramid`` with the
    tracer on, and none with it off; the outputs the same either way."""
    model = _seeded(teva.EVA02(**KW))
    x = _images()
    with torch.no_grad():
        off = model(x)
        assert tracer.collect() == {}
        tracer.enable()
        on = model(x)
        table = tracer.collect()
    assert {k: v["count"] for k, v in table.items()} == {
        "eva02.window_block": 2, "eva02.global_block": 1,
        "eva02.pyramid": 1}
    assert all(v["parents"] == [None] for v in table.values())
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_spans_cover_the_remats_recompute(tracer):
    """With the block remat, the backward's recompute of each block opens
    its span again."""
    model = _seeded(teva.EVA02(**KW, use_act_checkpoint=True))
    tracer.enable()
    feats = model(_images(), deterministic=True)
    sum(f.sum() for f in feats).backward()
    counts = {k: v["count"] for k, v in tracer.collect().items()}
    assert counts == {"eva02.window_block": 4, "eva02.global_block": 2,
                      "eva02.pyramid": 1}


def test_split_attention_counters():
    """A frame counts one global and two windowed attention calls, and the
    windowed calls' tokens: 6 views x 3 windows x 16 tokens padded, 6 x 40
    real, each call; the CPU launches no kernel."""
    model = _seeded(teva.EVA02(**KW))
    fn = tatt.eva_attention
    names = ("global_calls", "window_calls", "window_tokens",
             "window_real_tokens", "launches")
    before = {n: getattr(fn, n) for n in names}
    with torch.no_grad():
        model(_images())
    delta = {n: getattr(fn, n) - before[n] for n in names}
    windows = VIEWS * (PADDED[0] // 4) * (PADDED[1] // 4)
    assert delta == {"global_calls": 1, "window_calls": 2,
                     "window_tokens": 2 * windows * 16,
                     "window_real_tokens": 2 * VIEWS * math.prod(GRID),
                     "launches": 0}


def test_published_frame_counts():
    """At 1600x640 a frame's windowed call computes over 126 windows of
    256 tokens, 32,256 against 24,000 real (reckoned from the shapes the
    trunk hands the op)."""
    grid = (640 // 16, 1600 // 16)
    y = torch.empty((VIEWS, *grid, 1), device="meta")
    parts, pad_hw = teva.window_partition(y, 16)
    assert parts.shape[0] == 126 and pad_hw == (48, 112)
    assert parts.shape[0] * 256 == 32256 and VIEWS * np.prod(grid) == 24000
