"""Feature Pyramid Network (counterpart of ``sparsebev_tpu/models/fpn.py``).

mmdet key names (``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``): 1x1
laterals, nearest top-down upsample (integer ratio) + add, 3x3 output
convs; extra levels (``num_outs`` > inputs) by stride-2 subsampling of the
last output (mmdet ``add_extra_convs=False``). Convolutions compute in their
input's dtype with fp32 parameters cast to it.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .layers import CastCache


class _ConvModule(nn.Module):
    """mmdet ConvModule without norm/act: keys ``<name>.conv.weight/bias``."""

    def __init__(self, cin: int, cout: int, k: int, pad: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=pad)
        self._casts = CastCache()

    def forward(self, x):
        w = self._casts.get("weight", self.conv.weight, x.dtype)
        b = self._casts.get("bias", self.conv.bias, x.dtype)
        return F.conv2d(x, w, b, padding=self.conv.padding)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(out_channels, out_channels, 3, pad=1)
             for _ in in_channels])
        self.num_outs = num_outs

    def forward(self, inputs):
        assert len(inputs) == len(self.lateral_convs)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            # integer-ratio nearest upsample == the JAX package's repeat
            up = F.interpolate(laterals[i], size=laterals[i - 1].shape[2:],
                               mode="nearest")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs
