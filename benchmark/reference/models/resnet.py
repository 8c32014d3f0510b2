"""ResNet-50/101 backbone (counterpart of ``sparsebev_tpu/models/resnet.py``).

mmdet key names (``conv1``, ``bn1``, ``layer{s}.{i}.conv{j}``,
``layer{s}.{i}.downsample.{0,1}``), pytorch-style bottlenecks (stride on the
3x3), frozen batch norm. Each conv + FrozenBN runs as ONE conv: the BN's
affine map ``y = x*s + t`` (``s = weight/sqrt(var+eps)``, ``t = bias -
mean*s``) folds into the conv weights in fp32, then the folded weights are
cast to the compute dtype (``_folded_conv_bn`` :45 in the JAX package). At
inference the folded weights are cached until a parameter or running
statistic changes. While autograd records and a source parameter requires
grad, the fold is computed inside the graph instead, uncached, so the
gradient reaches the conv weight and the BN ``weight`` / ``bias`` (the
running statistics stay fixed: ``norm_eval``).

Convolutions run through ``F.conv2d`` in channels_last memory format (the JAX
package likewise leaves convolutions to XLA). ``with_cp`` checkpoints each
bottleneck in training (``torch.utils.checkpoint``; ``nn.remat`` per block in
the JAX package): its activations are recomputed in the backward pass.
``frozen_stages`` is enforced by the optimizer's multipliers
(``train/optim.py``), as in the JAX package; ``norm_eval`` and ``style`` are
accepted for config parity.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm in permanent eval mode (keys weight/bias/running_mean/var)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))


class ConvBN:
    """conv (no bias) + FrozenBatchNorm2d computed as one folded conv.

    Not a module: the conv and BN stay registered under their own names on
    the parent module (so the state-dict keys stay mmdet's); this object
    only refers to them."""

    def __init__(self, conv: nn.Conv2d, bn: FrozenBatchNorm2d):
        self._conv = conv
        self._bn = bn
        self._key = None
        self._w = self._t = None

    def _fold(self, dtype):
        conv, bn = self._conv, self._bn
        rs = torch.rsqrt(bn.running_var.float() + bn.eps)
        inv = rs * bn.weight.float()
        w = conv.weight.float() * inv[:, None, None, None]
        t = bn.bias.float() - bn.running_mean.float() * rs * bn.weight.float()
        return (w.to(dtype).contiguous(memory_format=torch.channels_last),
                t.to(dtype))

    def _folded(self, dtype, device):
        conv, bn = self._conv, self._bn
        if torch.is_grad_enabled() and (conv.weight.requires_grad
                                        or bn.weight.requires_grad
                                        or bn.bias.requires_grad):
            return self._fold(dtype)    # in the graph: the parameters train
        srcs = (conv.weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var)
        key = (dtype, device) + tuple((t.data_ptr(), t._version) for t in srcs)
        if key != self._key:
            with torch.no_grad():
                self._w, self._t = self._fold(dtype)
            self._key = key
        return self._w, self._t

    def __call__(self, x):
        w, t = self._folded(x.dtype, x.device)
        conv = self._conv
        return F.conv2d(x, w, t, conv.stride, conv.padding)


class Bottleneck(nn.Module):
    """pytorch-style bottleneck: 1x1 -> 3x3(stride) -> 1x1 (x4), residual."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(cout))
        self._cbn = [ConvBN(self.conv1, self.bn1), ConvBN(self.conv2, self.bn2),
                     ConvBN(self.conv3, self.bn3)]
        self._down = (ConvBN(self.downsample[0], self.downsample[1])
                      if downsample else None)

    def forward(self, x):
        identity = x if self._down is None else self._down(x)
        out = F.relu(self._cbn[0](x))
        out = F.relu(self._cbn[1](out))
        out = self._cbn[2](out)
        return F.relu(out + identity)


_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNet(nn.Module):
    """ResNet with bottleneck blocks. Input ``[B, 3, H, W]`` (channels_last
    memory); returns the stages in ``out_indices``."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = 1, norm_eval: bool = True,
                 style: str = "pytorch", with_cp: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        self.frozen_stages = frozen_stages
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self._stem = ConvBN(self.conv1, self.bn1)
        cin, planes = 64, 64
        self.num_stages = num_stages
        for s, nb in enumerate(_STAGE_BLOCKS[depth][:num_stages]):
            blocks = []
            for i in range(nb):
                stride = (1 if s == 0 else 2) if i == 0 else 1
                blocks.append(Bottleneck(cin, planes, stride,
                                         downsample=(i == 0)))
                cin = planes * Bottleneck.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        x = F.relu(self._stem(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for s in range(self.num_stages):
            for block in getattr(self, f"layer{s + 1}"):
                if self.with_cp and torch.is_grad_enabled() \
                        and x.requires_grad:
                    x = checkpoint(block, x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = block(x)
            if s in self.out_indices:
                outs.append(x)
        return outs
