"""ResNeXt-152-C4 trunk + C5 box head (the VinVL AttrRCNN backbone), port of
nl_vsgg_tpu/detector/resnet.py.

The network of models/vinvl/vinvl_x152c4.yaml (CONV_BODY "R-152-C4",
NUM_GROUPS 32, WIDTH_PER_GROUP 8, STRIDE_IN_1X1 False): a 7x7/2 stem + 3x3/2
max-pool, stages of (3, 8, 36) bottlenecks to the stride-16, 1024-channel C4
map, and stage 5 (3 bottlenecks, stride 2, 2048 channels) as the box head
over 14x14 RoI crops. Every BatchNorm is a frozen affine `x * scale + bias`
(maskrcnn's FrozenBatchNorm2d folded at conversion).

Modules take and return NCHW tensors, kept in channels_last memory, so the
NHWC view the kernels and the JAX package use is a free permute.

Grouped convs use native groups=32: the JAX package's EFF_GROUPS
block-diagonal packing is a TPU layout device and has no counterpart here.
Every stride-1 conv2 runs through `ops.grouped_conv.grouped_conv3x3` (the
hand kernel) with bn2's scale folded into its weights and bn2's bias and
the ReLU fused in its epilogue. `fused=False` takes the kernel's plain
version instead (the comparison path of chip_smoke.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_conv import grouped_conv3x3, grouped_conv3x3_reference

R152_BLOCKS = (3, 8, 36, 3)
WIDTHS = (256, 512, 1024, 2048)   # 32x8d: mid == out, doubling per stage
STEM = 64


class FrozenBN(nn.Module):
    """Inference-form BatchNorm: y = x * scale + bias per channel."""

    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    """maskrcnn_benchmark BottleneckWithFixedBatchNorm, STRIDE_IN_1X1=False
    (the stride lives in the grouped 3x3 conv)."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 stride: int = 1, groups: int = 32, has_downsample: bool = False,
                 fused: bool = True):
        super().__init__()
        self.stride, self.groups, self.fused = stride, groups, fused
        self.conv1 = nn.Conv2d(in_channels, mid_channels, 1, bias=False)
        self.bn1 = FrozenBN(mid_channels)
        self.conv2 = nn.Conv2d(mid_channels, mid_channels, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = FrozenBN(mid_channels)
        self.conv3 = nn.Conv2d(mid_channels, out_channels, 1, bias=False)
        self.bn3 = FrozenBN(out_channels)
        if has_downsample:
            self.downsample_conv = nn.Conv2d(in_channels, out_channels, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(out_channels)
        else:
            self.downsample_conv = None

    def _conv2(self, h: torch.Tensor) -> torch.Tensor:
        """conv2 + bn2 + ReLU."""
        if self.stride != 1:
            # The three stride-2 conv2s (first blocks of layer2-4) stay cuDNN
            # by design: the TPU kernel this port replaces is stride-1 only,
            # and the JAX package leaves every conv to XLA.
            return F.relu(self.bn2(self.conv2(h)))
        w = (self.conv2.weight.float() * self.bn2.scale.float().view(-1, 1, 1, 1))
        w = w.permute(2, 3, 1, 0).contiguous().to(h.dtype)            # OIHW -> HWIO
        conv = grouped_conv3x3 if self.fused else grouped_conv3x3_reference
        y = conv(h.permute(0, 2, 3, 1), w, self.groups, self.bn2.bias.float(), relu=True)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn3(self.conv3(self._conv2(h)))
        idn = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + idn)


class Stage(nn.Module):
    """`num_blocks` bottlenecks named block0, block1, ...; the first strides
    and projects the identity."""

    def __init__(self, num_blocks: int, in_channels: int, mid_channels: int,
                 out_channels: int, first_stride: int, groups: int = 32, fused: bool = True):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_channels if i == 0 else out_channels, mid_channels, out_channels,
                first_stride if i == 0 else 1, groups, has_downsample=(i == 0), fused=fused))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNeXt152C4(nn.Module):
    """Stem + stages 2-4: images (N, 3, H, W) -> (N, 1024, H/16, W/16)."""

    def __init__(self, groups: int = 32, fused: bool = True):
        super().__init__()
        self.stem_conv1 = nn.Conv2d(3, STEM, 7, 2, 3, bias=False)
        self.stem_bn1 = FrozenBN(STEM)
        ins = (STEM,) + WIDTHS[:2]
        for k in range(3):
            self.add_module(f"layer{k + 1}", Stage(R152_BLOCKS[k], ins[k], WIDTHS[k], WIDTHS[k],
                                                   1 if k == 0 else 2, groups, fused))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.stem_bn1(self.stem_conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)   # pads with -inf, as nn.max_pool in the JAX package
        return self.layer3(self.layer2(self.layer1(h)))


class ResNeXtC5Head(nn.Module):
    """Stage 5 over RoI crops: (N, 1024, 14, 14) -> (N, 2048, 7, 7)
    (roi_heads.box.feature_extractor.head of the reference)."""

    def __init__(self, groups: int = 32, fused: bool = True):
        super().__init__()
        self.layer4 = Stage(R152_BLOCKS[3], WIDTHS[2], WIDTHS[3], WIDTHS[3], 2, groups, fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(x)
