"""fp32 convolutions and products of the port's backbones stay fp32 on CUDA.

cuDNN runs an fp32 convolution in TF32 (a 10-bit mantissa) while
``torch.backends.cudnn.conv.fp32_precision`` is "tf32", PyTorch's default,
and cuBLAS an fp32 matrix product in TF32 while
``torch.backends.cuda.matmul.fp32_precision`` is "tf32". The JAX package
computes both in fp32, so the port runs its backbones and necks, and the
train step's backward, under ``utils/device.py::fp32_precision``. Here the
process-wide settings are TF32 first, set through the per-backend API or the
legacy one; a small detector's frame pass (ResNet-50 + FPN, VoVNet-99 + FPN,
EVA02 with its pyramid, all fp32, the test configs of the streaming tests)
records both settings at every ``F.conv2d`` / ``F.conv_transpose2d`` call,
and at every ``F.linear`` call inside the backbone (the EVA02 trunk's
products), and a training step records them at every convolution backward:
all must read fp32, and the process-wide settings must be back to TF32
afterwards. The CPU reads neither setting, so only the scope is checked
here; ``chip_smoke.py`` checks a conv's result on the card."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from sparsebev_tpu_torch.models.detector import build_detector, random_init_
from sparsebev_tpu_torch.train.step import create_train_state, make_train_step
from sparsebev_tpu_torch.utils.device import fp32_precision

import test_torch_eva02_streaming as eva_cfg
import test_torch_remat as train_cfg
import test_torch_streaming as r50_cfg
import test_torch_vov_streaming as vov_cfg

torch.set_num_threads(1)

CONFIGS = dict(r50=r50_cfg, vov99=vov_cfg, eva02=eva_cfg)


FP32 = ("ieee", "ieee")
TF32 = ("tf32", "tf32")


def _flags():
    """The settings cuDNN's convolutions and cuBLAS's products read."""
    return (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision)


def _set_tf32(api):
    if api == "per-backend":
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    else:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True


@pytest.fixture(params=["per-backend", "legacy"])
def tf32_everywhere(request):
    """The process-wide settings set to TF32 for the test through one API,
    then restored."""
    settings = (torch.backends.cudnn.conv, torch.backends.cuda.matmul)
    saved = [s.fp32_precision for s in settings]
    _set_tf32(request.param)
    assert _flags() == TF32
    try:
        yield
    finally:
        for s, value in zip(settings, saved):
            s.fp32_precision = value


def test_scope_sets_and_restores_the_flags(tf32_everywhere):
    with fp32_precision():
        assert _flags() == FP32
    assert _flags() == TF32
    assert torch.backends.cudnn.allow_tf32 is True      # the legacy getter
    with pytest.raises(RuntimeError):
        with fp32_precision():
            raise RuntimeError("inside")
    assert _flags() == TF32


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_pass_convs_run_in_fp32(name, tf32_everywhere, monkeypatch):
    mod = CONFIGS[name]
    model = build_detector({"model": copy.deepcopy(mod.MODEL)}, device="cpu",
                           seed=0)
    assert model.compute_dtype == torch.float32
    seen = {"conv": [], "linear": []}
    inside = []

    def recording(kind, fn):
        def call(*a, **k):
            if kind == "conv" or inside:
                seen[kind].append(_flags())
            return fn(*a, **k)
        return call

    for fname in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(F, fname, recording("conv", getattr(F, fname)))
    monkeypatch.setattr(F, "linear", recording("linear", F.linear))
    model.img_backbone.register_forward_pre_hook(
        lambda *_: inside.append(True))
    model.img_backbone.register_forward_hook(lambda *_: inside.clear())

    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(
        0, 256, (1, mod.N, mod.H, mod.W, 3)).astype(np.uint8))
    with torch.inference_mode():
        model.forward_frame_packed(img)

    assert seen["conv"], "the frame pass ran no convolution"
    assert set(seen["conv"]) == {FP32}
    if name == "eva02":
        assert len(seen["linear"]) >= 4 * mod.MODEL["img_backbone"]["depth"]
    assert set(seen["linear"]) <= {FP32}
    assert _flags() == TF32


class _RecordConvBackward(TorchDispatchMode):
    """The settings at every ``aten.convolution_backward`` call."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.seen.append(_flags())
        return func(*args, **(kwargs or {}))


def test_train_step_conv_gradients_run_in_fp32(tf32_everywhere):
    """One DN-on step of a small fp32 VoVNet SparseBEV (the remat test's
    config, remats off): every conv's backward reads fp32."""
    model = random_init_(build_detector(
        {"model": copy.deepcopy(train_cfg.MODEL)}, device="cpu"), 0)
    model.pts_bbox_head.transformer.decoder.with_cp = False
    model.img_backbone.with_cp = False
    step = make_train_step(train_cfg.NUM_CLASSES, train_cfg.CW, train_cfg.PC,
                           train_cfg.Q, dn_groups=train_cfg.DN_GROUPS)
    state = create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.0))
    record = _RecordConvBackward()
    with record:
        step(state, train_cfg._batch(), generator=torch.Generator()
             .manual_seed(3))
    assert len(record.seen) >= sum(
        isinstance(m, torch.nn.Conv2d) and m.weight.requires_grad
        for m in model.img_backbone.modules())
    assert set(record.seen) == {FP32}
    assert _flags() == TF32
