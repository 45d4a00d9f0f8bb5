"""Deep Layer Aggregation backbone (DLA-34), counterpart of
dd3d_tpu/models/dla.py: recursive Tree aggregation of BasicBlocks with Root
nodes, six levels with strides 1..32, and the plain stem.

TPU.S2D_STEM, S2D_STEM_FOLD and S2D_BASE4 select exact rewrites of the plain
stem for TPU layouts (tests/test_s2d_stem.py); the port reads none of them
and always runs the plain stem.
"""
import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models import register_backbone
from dd3d_tpu_torch.models.fpn import FPN
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


class Root(nn.Module):
    """Aggregation node: 1x1 conv over the concatenated children (DLA-34 has
    no residual root)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str):
        super().__init__()
        self.conv = ConvNorm(in_channels, out_channels, 1, 1, norm=norm)

    def forward(self, *children):
        return F.relu(self.conv(torch.cat(children, dim=1)))


class Tree(nn.Module):
    """Recursive DLA tree of BasicBlocks. `project` exists only on a leaf tree
    whose channel count changes; the stride-2 downsample is a 2x2 VALID
    max-pool."""

    def __init__(self, levels: int, in_channels: int, out_channels: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0, norm: str = "BN"):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels, self.level_root, self.stride = levels, level_root, stride
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride, norm)
            self.tree2 = BasicBlock(out_channels, out_channels, 1, norm)
            self.root = Root(root_dim, out_channels, norm)
            self.project = (ConvNorm(in_channels, out_channels, 1, 1, norm=norm)
                            if in_channels != out_channels else None)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride, norm=norm)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, root_dim=root_dim + out_channels, norm=norm)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """DLA trunk; returns a dict of `level{i}` features (stride 2**i)."""

    def __init__(self, levels, channels, out_features=("level3", "level4", "level5"), norm: str = "BN"):
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
        self.level2 = Tree(levels[2], channels[1], channels[2], 2, level_root=False, norm=norm)
        for lvl in (3, 4, 5):
            self.add_module(f"level{lvl}", Tree(levels[lvl], channels[lvl - 1], channels[lvl], 2,
                                                level_root=True, norm=norm))

    def forward(self, x):
        outputs = {}
        x = self.base_layer(x)
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            if f"level{i}" in self.out_features:
                outputs[f"level{i}"] = x
        return outputs


# name -> (levels, channels); the DLA-34 row of dd3d_tpu/models/dla.py:349
# (BasicBlock, no residual root). The other variants are not ported yet.
DLA_VARIANTS = {
    "DLA-34": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512]),
}

DLA_STRIDES = {f"level{i}": 2 ** i for i in range(6)}


def _dla_trunk(cfg):
    name = cfg.FE.BACKBONE.NAME
    if name not in DLA_VARIANTS:
        raise NotImplementedError(f"FE.BACKBONE.NAME={name!r} is not ported; ported: {sorted(DLA_VARIANTS)}")
    levels, channels = DLA_VARIANTS[name]
    trunk = DLA(levels, channels, out_features=tuple(cfg.FE.BACKBONE.OUT_FEATURES), norm=cfg.FE.BACKBONE.NORM)
    return trunk, {f"level{i}": channels[i] for i in range(6)}, DLA_STRIDES


@register_backbone("build_fcos_dla_fpn_backbone_p67")
def build_fcos_dla_fpn_backbone_p67(cfg):
    """DLA + FPN + P6P7 top block (strides 8..128); the KITTI backbone."""
    trunk, trunk_channels, trunk_strides = _dla_trunk(cfg)
    return FPN(
        bottom_up=trunk,
        in_features=tuple(cfg.FE.FPN.IN_FEATURES),
        in_channels={f: trunk_channels[f] for f in cfg.FE.FPN.IN_FEATURES},
        in_strides={f: trunk_strides[f] for f in cfg.FE.FPN.IN_FEATURES},
        out_channels=cfg.FE.FPN.OUT_CHANNELS,
        norm=cfg.FE.FPN.NORM,
        fuse_type=cfg.FE.FPN.FUSE_TYPE,
    )
