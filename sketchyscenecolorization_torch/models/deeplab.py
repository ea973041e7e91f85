"""DeepLab-v2 (ResNet-101) backbone with frozen batch-norm, output stride 8
(``sketchyscenecolorization_tpu/models/deeplab.py``; reference
``Instance_Matching/deeplab_model.py``).

Bottleneck units [3, 4, 23, 3], atrous rate 2 in group_4 and 4 in group_5;
frozen BN divides its stored moments by a stored ``factor``, eps 0.001.
Submodules carry the JAX tree's names (``group_2_0/block_1/conv/DW``) so
``utils/bridge.py`` maps the trees 1:1.  Only the intermediate feature map
(the RMI path) is built; the ASPP head is not part of it.  Under the bf16
compute-dtype scope (``ops/conv.py``) each conv stores bf16 and the frozen
BN's f32 parameters bring the stream back to f32 (JAX
``deeplab.py:119-157``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv import conv2d, max_pool_3x3_s2
from ..ops.norm import frozen_batch_norm

FILTERS = (64, 256, 512, 1024, 2048)
NUM_UNITS = (3, 4, 23, 3)


class ConvW(nn.Module):
    """A bias-free conv kernel ``DW`` [O, I, k, k], He-normal init."""

    def __init__(self, k: int, cin: int, cout: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = (2.0 / (k * k * cout)) ** 0.5
        self.DW = nn.Parameter(
            torch.randn(cout, cin, k, k, generator=generator) * std)


class FrozenBN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.beta = nn.Parameter(torch.zeros(c))
        self.gamma = nn.Parameter(torch.ones(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.variance = nn.Parameter(torch.ones(c))
        self.factor = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return frozen_batch_norm(x, self.mean, self.variance, self.beta,
                                 self.gamma, self.factor)


class ConvBN(nn.Module):
    def __init__(self, k, cin, cout, generator=None):
        super().__init__()
        self.conv = ConvW(k, cin, cout, generator)
        self.bn = FrozenBN(cout)

    def forward(self, x, stride=1, rate=1):
        return self.bn(conv2d(x, self.conv.DW, stride=stride, rate=rate))


class Bottleneck(nn.Module):
    """Reference ``deeplab_model.py:233-260``."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        mid = cout // 4
        self.block_1 = ConvBN(1, cin, mid, generator)
        self.block_2 = ConvBN(3, mid, mid, generator)
        self.block_3 = ConvBN(1, mid, cout, generator)
        self.block_add = (ConvBN(1, cin, cout, generator)
                          if cin != cout else None)

    def forward(self, x, stride: int, atrous: int):
        y = torch.relu(self.block_1(x, stride, atrous))
        y = torch.relu(self.block_2(y, 1, atrous))
        y = self.block_3(y, 1, atrous)
        orig = x if self.block_add is None else self.block_add(x, stride, atrous)
        return torch.relu(y + orig)


class Stem(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        self.conv1 = ConvW(7, 3, FILTERS[0], generator)
        self.bn_conv1 = FrozenBN(FILTERS[0])


_GROUPS = (("group_2", 1, 1), ("group_3", 2, 1), ("group_4", 1, 2),
           ("group_5", 1, 4))      # (name, stride, atrous rate)


class DeepLabV2(nn.Module):
    """images [N, H, W, 3] mean-subtracted -> features [N, H/8, W/8, 2048]."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group_1 = Stem(generator)
        for g, (name, _, _) in enumerate(_GROUPS):
            cin, cout = FILTERS[g], FILTERS[g + 1]
            for i in range(NUM_UNITS[g]):
                self.add_module(f"{name}_{i}", Bottleneck(
                    cin if i == 0 else cout, cout, generator))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = conv2d(images, self.group_1.conv1.DW, stride=2)
        x = torch.relu(self.group_1.bn_conv1(x))
        x = max_pool_3x3_s2(x)
        for g, (name, stride, atrous) in enumerate(_GROUPS):
            for i in range(NUM_UNITS[g]):
                x = getattr(self, f"{name}_{i}")(
                    x, stride if i == 0 else 1, atrous)
        return torch.relu(x)   # group_last
