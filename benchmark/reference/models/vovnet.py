"""VoVNet backbone (counterpart of ``sparsebev_tpu/models/vovnet.py``): OSA
modules with dense aggregation and eSE channel attention.

Module names are the reference's state-dict keys (``stem.stem_1/conv``,
``stage2.OSA2_1.layers.0.OSA2_1_0/norm``,
``stage2.OSA2_1.concat.OSA2_1_concat/conv``, ``stage2.OSA2_1.ese.fc``), so
this module is the inverse of the JAX package's
``utils/checkpoint_io.py::_port_vovnet``: reference block ``OSA{n}_{b}`` is
1-based where the JAX tree's ``stage{n}_block{b-1}`` is 0-based.

As in the JAX VoVNet, the frozen batch norm runs AFTER each conv rather than
folded into it: ``inv`` and ``shift`` are computed in fp32, cast to the
compute dtype, then ``x * inv + shift`` (``resnet.py:23-42`` of the JAX
package), so bf16 features follow the JAX order. eSE runs in every block
(the reference's dead SE flag), and blocks after a stage's first add their
input. Convolutions run through ``F.conv2d`` in channels_last memory.

``with_cp`` checkpoints each OSA module while autograd records
(``torch.utils.checkpoint``, non-reentrant; ``nn.remat(OSAModule)`` in the
JAX VoVNet): only its input is kept and its activations are recomputed in
the backward pass. Each stage's max pool runs inside its first block's
region, so its backward keeps no int64 indices either. A recompute gives
the same bits, so neither changes a number. The stem is not checkpointed,
as in the JAX VoVNet.

``frozen_stages`` is enforced by the optimizer's multipliers
(``train/optim.py``); ``norm_eval`` is accepted for config parity.

The depthwise specs (``V-19-slim-dw-eSE``, ``V-19-dw-eSE``; JAX
``vovnet.py:49-60``, ``:98-106``): the stem's second and third convs and
every OSA layer are a depthwise 3x3 (one group a channel, the stride on
it) then a pointwise 1x1, then the frozen BN and ReLU, under the
reference's ``dw_conv3x3`` names (``<tag>/dw_conv3x3``,
``<tag>/pw_conv1x1``, ``<tag>/pw_norm``); an OSA module whose input width
is not its stage width first reduces it with a 1x1 conv + BN + ReLU
(``conv_reduction.<tag>_reduction_0/conv``, ``/norm``), while its concat
still takes the unreduced input. The JAX package's reference ``.pth`` map
has no depthwise keys, so only ``utils/convert.py::state_dict_from_jax``
carries such weights.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import CastCache
from .resnet import FrozenBatchNorm2d

_STAGE_SPECS: Dict[str, Dict[str, Any]] = {
    "V-19-slim-dw-eSE": dict(stem=[64, 64, 64], stage_conv_ch=[64, 80, 96, 112],
                             stage_out_ch=[112, 256, 384, 512], layer_per_block=3,
                             block_per_stage=[1, 1, 1, 1], eSE=True, dw=True),
    "V-19-dw-eSE": dict(stem=[64, 64, 64], stage_conv_ch=[128, 160, 192, 224],
                        stage_out_ch=[256, 512, 768, 1024], layer_per_block=3,
                        block_per_stage=[1, 1, 1, 1], eSE=True, dw=True),
    "V-19-slim-eSE": dict(stem=[64, 64, 128], stage_conv_ch=[64, 80, 96, 112],
                          stage_out_ch=[112, 256, 384, 512], layer_per_block=3,
                          block_per_stage=[1, 1, 1, 1], eSE=True, dw=False),
    "V-19-eSE": dict(stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
                     stage_out_ch=[256, 512, 768, 1024], layer_per_block=3,
                     block_per_stage=[1, 1, 1, 1], eSE=True, dw=False),
    "V-39-eSE": dict(stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
                     stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
                     block_per_stage=[1, 1, 2, 2], eSE=True, dw=False),
    "V-57-eSE": dict(stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
                     stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
                     block_per_stage=[1, 1, 4, 3], eSE=True, dw=False),
    "V-99-eSE": dict(stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
                     stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
                     block_per_stage=[1, 3, 9, 3], eSE=True, dw=False),
}


class _ConvNormReLU:
    """conv (no bias) -> FrozenBN -> ReLU, or with ``depthwise`` a
    depthwise conv then a pointwise 1x1 before the BN. Not a module: the
    convs and norm are registered on ``parent`` under the reference's
    ``<tag>/conv`` and ``<tag>/norm`` names (``<tag>/dw_conv3x3``,
    ``<tag>/pw_conv1x1`` and ``<tag>/pw_norm`` when depthwise); this object
    only refers to them."""

    def __init__(self, parent: nn.Module, tag: str, cin: int, cout: int,
                 kernel: int = 3, stride: int = 1, depthwise: bool = False):
        if depthwise:
            self.convs = (
                nn.Conv2d(cin, cin, kernel, stride=stride,
                          padding=kernel // 2, groups=cin, bias=False),
                nn.Conv2d(cin, cout, 1, bias=False))
            names = (f"{tag}/dw_conv3x3", f"{tag}/pw_conv1x1",
                     f"{tag}/pw_norm")
        else:
            self.convs = (nn.Conv2d(cin, cout, kernel, stride=stride,
                                    padding=kernel // 2, bias=False),)
            names = (f"{tag}/conv", f"{tag}/norm")
        self.norm = FrozenBatchNorm2d(cout)
        for name, mod in zip(names, self.convs + (self.norm,)):
            parent.add_module(name, mod)
        self._casts = CastCache()
        self._key = None
        self._affine = None

    def _inv_shift(self, dtype, device):
        """The frozen BN as ``x * inv + shift``: computed in fp32, cast to
        the compute dtype (the JAX ``FrozenBatchNorm``), and cached until a
        parameter or running statistic changes."""
        bn = self.norm

        def affine():
            rs = torch.rsqrt(bn.running_var.float() + bn.eps)
            inv = rs * bn.weight.float()
            shift = bn.bias.float() - bn.running_mean.float() * rs \
                * bn.weight.float()
            return (inv.to(dtype)[:, None, None],
                    shift.to(dtype)[:, None, None])

        if torch.is_grad_enabled() and (bn.weight.requires_grad
                                        or bn.bias.requires_grad):
            return affine()     # in the graph: the BN affine trains
        srcs = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        key = (dtype, device) + tuple((t.data_ptr(), t._version) for t in srcs)
        if key != self._key:
            with torch.no_grad():
                self._affine = affine()
            self._key = key
        return self._affine

    def __call__(self, x):
        for i, conv in enumerate(self.convs):
            w = self._casts.get(f"weight{i}", conv.weight, x.dtype)
            x = F.conv2d(x, w, None, conv.stride, conv.padding, 1,
                         conv.groups)
        inv, shift = self._inv_shift(x.dtype, x.device)
        return F.relu(x * inv + shift)


class ESEModule(nn.Module):
    """Effective squeeze-excite: global average pool -> 1x1 conv with bias
    -> hard sigmoid gate ``clip(x + 3, 0, 6) / 6``."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1)
        self._casts = CastCache()

    def forward(self, x):
        gap = x.mean(dim=(2, 3), keepdim=True)
        gate = F.conv2d(gap, self._casts.get("weight", self.fc.weight, x.dtype),
                        self._casts.get("bias", self.fc.bias, x.dtype))
        return x * (torch.clamp(gate + 3.0, 0.0, 6.0) / 6.0)


class OSAModule(nn.Module):
    """One-shot aggregation: ``layer_per_block`` 3x3 convs whose outputs all
    concatenate with the input, a 1x1 reduce, eSE, and the identity add for
    every block after a stage's first. ``depthwise``: the 3x3 convs are
    depthwise + pointwise, after a 1x1 reduction of an input wider or
    narrower than ``stage_ch``."""

    def __init__(self, cin: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, tag: str, identity: bool = False,
                 depthwise: bool = False):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList()
        self._layers = []
        self._reduction = None
        ch = cin
        if depthwise and cin != stage_ch:
            self.conv_reduction = nn.Module()
            self._reduction = _ConvNormReLU(
                self.conv_reduction, f"{tag}_reduction_0", cin, stage_ch, 1)
            ch = stage_ch
        for i in range(layer_per_block):
            seq = nn.Module()
            self._layers.append(_ConvNormReLU(seq, f"{tag}_{i}", ch,
                                              stage_ch, 3,
                                              depthwise=depthwise))
            self.layers.append(seq)
            ch = stage_ch
        self.concat = nn.Module()
        self._concat = _ConvNormReLU(
            self.concat, f"{tag}_concat", cin + layer_per_block * stage_ch,
            concat_ch, 1)
        self.ese = ESEModule(concat_ch)

    def forward(self, x):
        identity_feat = x
        outputs = [x]
        if self._reduction is not None:
            x = self._reduction(x)
        for layer in self._layers:
            x = layer(x)
            outputs.append(x)
        x = self._concat(torch.cat(outputs, dim=1))
        x = self.ese(x)
        if self.identity:
            x = x + identity_feat
        return x


class VoVNet(nn.Module):
    """Input ``[B, 3, H, W]`` (channels_last memory); returns the stages
    named in ``out_features`` (of ``stem``, ``stage2`` ... ``stage5``) in
    order."""

    def __init__(self, spec_name: str = "V-99-eSE",
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4",
                                                "stage5"),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 with_cp: bool = False, input_ch: int = 3):
        super().__init__()
        spec = _STAGE_SPECS[spec_name]
        dw = spec["dw"]
        self.out_features = tuple(out_features)
        self.with_cp = with_cp
        stem_ch = spec["stem"]
        self.stem = nn.Module()
        self._stem = [
            _ConvNormReLU(self.stem, "stem_1", input_ch, stem_ch[0], 3, 2),
            _ConvNormReLU(self.stem, "stem_2", stem_ch[0], stem_ch[1], 3, 1,
                          depthwise=dw),
            _ConvNormReLU(self.stem, "stem_3", stem_ch[1], stem_ch[2], 3, 2,
                          depthwise=dw),
        ]
        cin = stem_ch[2]
        for i in range(4):
            n = i + 2
            stage = nn.Module()
            for b in range(spec["block_per_stage"][i]):
                stage.add_module(f"OSA{n}_{b + 1}", OSAModule(
                    cin, spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                    spec["layer_per_block"], f"OSA{n}_{b + 1}",
                    identity=b > 0, depthwise=dw))
                cin = spec["stage_out_ch"][i]
            setattr(self, f"stage{n}", stage)

    def forward(self, x):
        remat = self.with_cp and torch.is_grad_enabled()
        for layer in self._stem:
            x = layer(x)
        outs = [x] if "stem" in self.out_features else []
        for n in range(2, 6):
            for b, block in enumerate(getattr(self, f"stage{n}").children()):
                run = block
                if n != 2 and b == 0:
                    # the stage's pool runs inside its first block's region:
                    # its backward then keeps no int64 indices
                    run = functools.partial(_pool_then, block)
                if remat:
                    x = checkpoint(run, x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = run(x)
            if f"stage{n}" in self.out_features:
                outs.append(x)
        return outs


def _pool_then(block, x):
    """ceil-mode 3x3/2 max pool (the JAX package's -inf bottom/right pad,
    then a VALID pool), then ``block``."""
    return block(F.max_pool2d(x, 3, stride=2, ceil_mode=True))
