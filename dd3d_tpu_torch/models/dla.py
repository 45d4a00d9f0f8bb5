"""Deep Layer Aggregation backbone (DLA), counterpart of
dd3d_tpu/models/dla.py: recursive Tree aggregation with Root nodes, six
levels with strides 1..32, the plain stem, and the ten variants of
`DLA_VARIANTS` built from three blocks (BasicBlock; Bottleneck, expansion 2;
BottleneckX, whose 3x3 is grouped with cardinality 32 or 64) with plain or
residual roots.

TPU.S2D_STEM, S2D_STEM_FOLD and S2D_BASE4 select exact rewrites of the plain
stem for TPU layouts (tests/test_s2d_stem.py); the port reads none of them
and always runs the plain stem.

TPU.PALLAS_STEM_DW routes the same two stem convs as the JAX package's s2d
stem does (dd3d_tpu/models/s2d.py:310-314, dla.py:304-311) through the
weight-gradient CUDA kernel in train mode: `base_layer` (7x7, 3->16) and
every `level0` conv (3x3, 16->16), all stride 1, in every variant. The
stride-2 `level1` conv stays on the library conv in both packages.

In eval on the card in bf16, `base_layer` (reading the uint8 frames,
normalized in its load), `level0` and `level1` each run as one launch of
ops/stem_conv's kernel, conv, folded-BN bias and ReLU together
(ConvNorm.takes_stem_kernel); `level0` and `level1` are one conv each in
every variant (levels[0] = levels[1] = 1, channels 16 and 32). So DD3D
hands the trunk the frames themselves (`reads_frames`), and `base_layer`
normalizes them.

BottleneckX's grouped 3x3 is a grouped ConvNorm: under TPU.QUANT_INT8 it
runs through ops/int8_conv.int8_conv_grouped, on the route its shape takes
(C/g = planes / 32: 4 and 8 on `direct`, 16 and 32 on `mma`).
"""
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models import register_backbone
from dd3d_tpu_torch.models.fpn import fpn_from_cfg
from dd3d_tpu_torch.models.layers import ConvNorm


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = ConvNorm(inplanes, planes, 3, stride, norm=norm)
        self.conv2 = ConvNorm(planes, planes, 3, 1, norm=norm)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 + residual, `width` wide inside:
    `planes // 2` (expansion 2; JAX dla.py:49-72), its 3x3 in `groups`."""

    def __init__(self, inplanes: int, planes: int, stride: int, norm: str, width: int = 0, groups: int = 1):
        super().__init__()
        width = width or planes // 2
        self.conv1 = ConvNorm(inplanes, width, 1, 1, norm=norm)
        self.conv2 = ConvNorm(width, width, 3, stride, norm=norm, groups=groups)
        self.conv3 = ConvNorm(width, planes, 1, 1, norm=norm)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + residual)


class BottleneckX(Bottleneck):
    """The grouped (ResNeXt) bottleneck: `planes * cardinality // 32` wide
    inside, its 3x3 in `cardinality` groups (JAX dla.py:73-98)."""

    def __init__(self, inplanes: int, planes: int, stride: int, norm: str, cardinality: int = 32):
        super().__init__(inplanes, planes, stride, norm, planes * cardinality // 32, cardinality)


class Root(nn.Module):
    """Aggregation node: 1x1 conv over the concatenated children, plus the
    first child where the root is residual."""

    def __init__(self, in_channels: int, out_channels: int, norm: str, residual: bool = False):
        super().__init__()
        self.conv = ConvNorm(in_channels, out_channels, 1, 1, norm=norm)
        self.residual = residual

    def forward(self, *children):
        x = self.conv(torch.cat(children, dim=1))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive DLA tree of `block`s. `project` exists only on a leaf tree
    whose channel count changes; the stride-2 downsample is a 2x2 VALID
    max-pool."""

    def __init__(self, levels: int, block, in_channels: int, out_channels: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0, root_residual: bool = False, norm: str = "BN"):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels, self.level_root, self.stride = levels, level_root, stride
        if levels == 1:
            self.tree1 = block(in_channels, out_channels, stride, norm)
            self.tree2 = block(out_channels, out_channels, 1, norm)
            self.root = Root(root_dim, out_channels, norm, root_residual)
            self.project = (ConvNorm(in_channels, out_channels, 1, 1, norm=norm)
                            if in_channels != out_channels else None)
        else:
            self.tree1 = Tree(levels - 1, block, in_channels, out_channels, stride, root_residual=root_residual,
                              norm=norm)
            self.tree2 = Tree(levels - 1, block, out_channels, out_channels, root_dim=root_dim + out_channels,
                              root_residual=root_residual, norm=norm)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            # Nothing reads them now: freed before tree2 and the root, where a
            # serving forward's memory peaks once the stem is fused (level2).
            del residual, bottom
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """DLA trunk; returns a dict of `level{i}` features (stride 2**i)."""

    reads_frames = True  # its first module, `base_layer`, takes NormalizedFrames (ConvNorm.forward)

    def __init__(self, levels, channels, block=BasicBlock, residual_root: bool = False,
                 out_features=("level3", "level4", "level5"), norm: str = "BN", kernel_stem_weight_grad: bool = False):
        super().__init__()
        self.out_features = tuple(out_features)
        self.base_layer = ConvNorm(3, channels[0], 7, 1, norm=norm, relu=True)
        # level0 / level1: plain conv stacks (the first level1 conv has stride 2).
        for i, stride in ((0, 1), (1, 2)):
            cin = channels[0]
            convs = []
            for j in range(levels[i]):
                convs.append(ConvNorm(cin, channels[i], 3, stride if j == 0 else 1, norm=norm, relu=True))
                cin = channels[i]
            self.add_module(f"level{i}", nn.Sequential(*convs))
        if kernel_stem_weight_grad:
            for conv in (self.base_layer, *self.level0):
                conv.route_weight_grad()
        self.level2 = Tree(levels[2], block, channels[1], channels[2], 2, level_root=False,
                           root_residual=residual_root, norm=norm)
        for lvl in (3, 4, 5):
            self.add_module(f"level{lvl}", Tree(levels[lvl], block, channels[lvl - 1], channels[lvl], 2,
                                                level_root=True, root_residual=residual_root, norm=norm))

    def forward(self, x):
        outputs = {}
        x = self.base_layer(x)
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            if f"level{i}" in self.out_features:
                outputs[f"level{i}"] = x
        return outputs


# name -> (levels, channels, block, residual_root): dd3d_tpu/models/dla.py:348-359
DLA_VARIANTS = {
    "DLA-34": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512], BasicBlock, False),
    "DLA-46-C": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 64, 128, 256], Bottleneck, False),
    "DLA-X-46-C": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 64, 128, 256], BottleneckX, False),
    "DLA-X-60-C": ([1, 1, 1, 2, 3, 1], [16, 32, 64, 64, 128, 256], BottleneckX, False),
    "DLA-60": ([1, 1, 1, 2, 3, 1], [16, 32, 128, 256, 512, 1024], Bottleneck, False),
    "DLA-X-60": ([1, 1, 1, 2, 3, 1], [16, 32, 128, 256, 512, 1024], BottleneckX, False),
    "DLA-102": ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], Bottleneck, True),
    "DLA-X-102": ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], BottleneckX, True),
    "DLA-X-102-64": ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024], partial(BottleneckX, cardinality=64), True),
    "DLA-169": ([1, 1, 2, 3, 5, 1], [16, 32, 128, 256, 512, 1024], Bottleneck, True),
}

DLA_STRIDES = {f"level{i}": 2 ** i for i in range(6)}


def _dla_trunk(cfg):
    name = cfg.FE.BACKBONE.NAME
    levels, channels, block, residual_root = DLA_VARIANTS[name]
    trunk = DLA(levels, channels, block, residual_root, out_features=tuple(cfg.FE.BACKBONE.OUT_FEATURES),
                norm=cfg.FE.BACKBONE.NORM, kernel_stem_weight_grad=bool(cfg.TPU.get("PALLAS_STEM_DW", False)))
    return trunk, {f"level{i}": channels[i] for i in range(6)}, DLA_STRIDES


def _dla_fpn(cfg, top_block: str):
    return fpn_from_cfg(cfg, *_dla_trunk(cfg), top_block)


@register_backbone("build_fcos_dla_fpn_backbone_p67")
def build_fcos_dla_fpn_backbone_p67(cfg):
    """DLA + FPN + P6P7 top block (strides 8..128); the KITTI backbone."""
    return _dla_fpn(cfg, "p6p7")


@register_backbone("build_fcos_dla_fpn_backbone_p6")
def build_fcos_dla_fpn_backbone_p6(cfg):
    """DLA + FPN + P6 top block (strides 8..64)."""
    return _dla_fpn(cfg, "p6")


@register_backbone("build_dla_fpn_backbone")
def build_dla_fpn_backbone(cfg):
    """DLA + FPN + max-pool top level (strides 8..64)."""
    return _dla_fpn(cfg, "maxpool")
