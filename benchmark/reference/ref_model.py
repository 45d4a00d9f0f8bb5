"""Frozen copy of tests/torch_ref_dd3d.py as of the commit that added the
benchmark (556a2543), the plain DD3D model, cut to the DLA-34 graph that
the benchmark's configurations run (the VoVNet and nuScenes classes and
`randomize_state` left out): kept under benchmark/ so that a later change
to the test oracle cannot move the yardstick. Plain PyTorch; it imports
nothing of the program. The original docstring follows.

PyTorch re-execution of the reference DD3D graph, for parity tests.

A faithful torch mirror of the DLA-34 + FPN(P6P7) + FCOS2D/FCOS3D graph with
state-dict names IDENTICAL to the reference checkpoints
(tridet/modeling/feature_extractor/dla.py, d2 FPN, tridet/modeling/dd3d/
fcos2d.py, fcos3d.py). Used to:
- generate a reference-named synthetic `.pth` covering EVERY tensor of the
  dd3d_kitti_dla34 experiment,
- provide golden full-model forward outputs for converter verification.

This is a test oracle, not product code: semantics re-derived from the
reference's module definitions (all normalizations run in eval mode, which
matches both BN-eval and FrozenBN).
"""
import torch
import torch.nn.functional as F
from torch import nn


class Conv2dN(nn.Conv2d):
    """detectron2-style Conv2d with fused .norm / .activation attributes."""

    def __init__(self, *args, norm=None, activation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x):
        x = super().forward(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class Scale(nn.Module):
    def __init__(self, init_value=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.FloatTensor([init_value]))

    def forward(self, x):
        return x * self.scale


class Offset(nn.Module):
    def __init__(self, init_value=0.0):
        super().__init__()
        self.bias = nn.Parameter(torch.FloatTensor([init_value]))

    def forward(self, x):
        return x + self.bias


class ModuleListDial(nn.ModuleList):
    """Round-robin module list: each call uses the next module (per-level BN
    inside a shared tower, tridet/layers/normalization.py:30-40)."""

    def __init__(self, modules=None):
        super().__init__(modules)
        self.cur_position = 0

    def forward(self, x):
        out = self[self.cur_position](x)
        self.cur_position = (self.cur_position + 1) % len(self)
        return out


def _bn(c):
    return nn.BatchNorm2d(c)


# --------------------------------------------------------------------------
# DLA trunk (dla.py:24-355)
# --------------------------------------------------------------------------

class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2dN(inplanes, planes, 3, stride=stride, padding=1, bias=False, norm=_bn(planes))
        self.conv2 = Conv2dN(planes, planes, 3, stride=1, padding=1, bias=False, norm=_bn(planes))

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        return F.relu(out + residual)


class Root(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, residual):
        super().__init__()
        self.conv = Conv2dN(in_channels, out_channels, kernel_size, stride=1, bias=False,
                            padding=(kernel_size - 1) // 2, norm=_bn(out_channels))
        self.residual = residual

    def forward(self, *children):
        x = self.conv(torch.cat(children, 1))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    def __init__(self, levels, block, in_channels, out_channels, stride=1,
                 level_root=False, root_dim=0, root_kernel_size=1, root_residual=False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if levels == 1:
            self.tree1 = block(in_channels, out_channels, stride)
            self.tree2 = block(out_channels, out_channels, 1)
        else:
            self.tree1 = Tree(levels - 1, block, in_channels, out_channels, stride,
                              root_dim=0, root_kernel_size=root_kernel_size, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, block, out_channels, out_channels,
                              root_dim=root_dim + out_channels, root_kernel_size=root_kernel_size,
                              root_residual=root_residual)
        if levels == 1:
            self.root = Root(root_dim, out_channels, root_kernel_size, root_residual)
        self.level_root = level_root
        self.levels = levels
        self.downsample = nn.MaxPool2d(stride, stride=stride) if stride > 1 else None
        self.project = None
        if in_channels != out_channels and not isinstance(self.tree1, Tree):
            self.project = Conv2dN(in_channels, out_channels, 1, stride=1, bias=False, norm=_bn(out_channels))

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            x = self.root(x2, x1, *children)
        else:
            children.append(x1)
            x = self.tree2(x1, children=children)
        return x


class DLA(nn.Module):
    def __init__(self, levels, channels, block=BasicBlock, out_features=("level3", "level4", "level5")):
        super().__init__()
        self.base_layer = Conv2dN(3, channels[0], 7, stride=1, padding=3, bias=False,
                                  norm=_bn(channels[0]), activation=F.relu)
        self.level0 = self._make_conv_level(channels[0], channels[0], levels[0])
        self.level1 = self._make_conv_level(channels[0], channels[1], levels[1], stride=2)
        self.level2 = Tree(levels[2], block, channels[1], channels[2], 2, level_root=False)
        self.level3 = Tree(levels[3], block, channels[2], channels[3], 2, level_root=True)
        self.level4 = Tree(levels[4], block, channels[3], channels[4], 2, level_root=True)
        self.level5 = Tree(levels[5], block, channels[4], channels[5], 2, level_root=True)
        self._out_features = out_features

    @staticmethod
    def _make_conv_level(inplanes, planes, convs, stride=1):
        modules = []
        for i in range(convs):
            modules.append(Conv2dN(inplanes, planes, 3, stride=stride if i == 0 else 1,
                                   padding=1, bias=False, norm=_bn(planes), activation=F.relu))
            inplanes = planes
        return nn.Sequential(*modules)

    def forward(self, x):
        outputs = {}
        x = self.base_layer(x)
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            if name in self._out_features:
                outputs[name] = x
        return outputs


# --------------------------------------------------------------------------
# d2-style FPN with LastLevelP6P7 (dla.py:536-561)
# --------------------------------------------------------------------------

class LastLevelP6P7(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, 2, 1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2, 1)

    def forward(self, c5):
        p6 = self.p6(c5)
        p7 = self.p7(F.relu(p6))
        return [p6, p7]


class LastLevelP6(nn.Module):
    """Single extra level from p5 (vovnet builder, dla.py:486-506)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, 2, 1)

    def forward(self, p5):
        return [self.p6(p5)]


class FPN(nn.Module):
    def __init__(self, bottom_up, in_features, in_channels, out_channels,
                 strides=None, top="p6p7"):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = list(in_features)
        strides = strides or {"level3": 8, "level4": 16, "level5": 32}
        for f in self.in_features:
            s = strides[f]
            idx = s.bit_length() - 1
            self.add_module(f"fpn_lateral{idx}",
                            Conv2dN(in_channels[f], out_channels, 1, bias=False, norm=_bn(out_channels)))
            self.add_module(f"fpn_output{idx}",
                            Conv2dN(out_channels, out_channels, 3, padding=1, bias=False, norm=_bn(out_channels)))
        self.top_block = (LastLevelP6P7(out_channels, out_channels) if top == "p6p7"
                          else LastLevelP6(out_channels, out_channels))
        self._strides = strides
        self._top = top

    def forward(self, x):
        feats = self.bottom_up(x)
        results = {}
        prev = None
        for f in reversed(self.in_features):
            idx = self._strides[f].bit_length() - 1
            lateral = getattr(self, f"fpn_lateral{idx}")(feats[f])
            if prev is not None:
                lateral = lateral + F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = lateral
            results[f"p{idx}"] = getattr(self, f"fpn_output{idx}")(lateral)
        if self._top == "p6p7":
            p6, p7 = self.top_block(results["p5"])
            results["p6"], results["p7"] = p6, p7
        else:
            results["p6"] = self.top_block(results["p5"])[0]
        return results


# --------------------------------------------------------------------------
# FCOS2D / FCOS3D heads, v2 towers (fcos2d.py:30-156, fcos3d.py:55-188)
# --------------------------------------------------------------------------

class FCOS2DHead(nn.Module):
    def __init__(self, num_classes, in_channels, strides, num_convs=4, scale_init_factor=1.0):
        super().__init__()
        num_levels = len(strides)
        for head in ("cls", "box2d"):
            tower = []
            for _ in range(num_convs):
                norm = ModuleListDial([_bn(in_channels) for _ in range(num_levels)])
                tower.append(Conv2dN(in_channels, in_channels, 3, stride=1, padding=1,
                                     bias=False, norm=norm, activation=F.relu))
            self.add_module(f"{head}_tower", nn.Sequential(*tower))
        self.cls_logits = nn.Conv2d(in_channels, num_classes, 3, stride=1, padding=1)
        self.box2d_reg = nn.Conv2d(in_channels, 4, 3, stride=1, padding=1)
        self.centerness = nn.Conv2d(in_channels, 1, 3, stride=1, padding=1)
        self.scales_box2d_reg = nn.ModuleList([Scale(s * scale_init_factor) for s in strides])

    def forward(self, features):
        logits, box2d, ctr, cls_tower_out = [], [], [], []
        for l, f in enumerate(features):
            c = self.cls_tower(f)
            b = self.box2d_tower(f)
            logits.append(self.cls_logits(c))
            ctr.append(self.centerness(b))
            box2d.append(F.relu(self.scales_box2d_reg[l](self.box2d_reg(b))))
            cls_tower_out.append(c)
        return logits, box2d, ctr, cls_tower_out


class FCOS3DHead(nn.Module):
    def __init__(self, num_classes, in_channels, strides, mean_depth, std_depth,
                 num_convs=4, depth_scale_init_factor=0.3, proj_ctr_scale_init_factor=1.0):
        super().__init__()
        num_levels = len(strides)
        tower = []
        for _ in range(num_convs):
            norm = ModuleListDial([_bn(in_channels) for _ in range(num_levels)])
            tower.append(Conv2dN(in_channels, in_channels, 3, stride=1, padding=1,
                                 bias=False, norm=norm, activation=F.relu))
        self.box3d_tower = nn.Sequential(*tower)
        self.box3d_quat = nn.ModuleList([nn.Conv2d(in_channels, 4 * num_classes, 3, 1, 1, bias=True)])
        self.box3d_ctr = nn.ModuleList([nn.Conv2d(in_channels, 2 * num_classes, 3, 1, 1, bias=True)])
        self.box3d_depth = nn.ModuleList([nn.Conv2d(in_channels, 1 * num_classes, 3, 1, 1, bias=False)])
        self.box3d_size = nn.ModuleList([nn.Conv2d(in_channels, 3 * num_classes, 3, 1, 1, bias=True)])
        self.box3d_conf = nn.ModuleList([nn.Conv2d(in_channels, 1 * num_classes, 3, 1, 1, bias=True)])
        self.scales_proj_ctr = nn.ModuleList([Scale(s * proj_ctr_scale_init_factor) for s in strides])
        self.scales_size = nn.ModuleList([Scale(1.0) for _ in strides])
        self.scales_conf = nn.ModuleList([Scale(1.0) for _ in strides])
        self.scales_depth = nn.ModuleList([Scale(s * depth_scale_init_factor) for s in std_depth])
        self.offsets_depth = nn.ModuleList([Offset(m) for m in mean_depth])
        # real checkpoints carry these buffers (fcos3d.py:67-68)
        self.register_buffer("mean_depth_per_level", torch.tensor(list(mean_depth)))
        self.register_buffer("std_depth_per_level", torch.tensor(list(std_depth)))

    def forward(self, features):
        quat, ctr, depth, size, conf = [], [], [], [], []
        for l, f in enumerate(features):
            x = self.box3d_tower(f)
            quat.append(self.box3d_quat[0](x))
            ctr.append(self.scales_proj_ctr[l](self.box3d_ctr[0](x)))
            depth.append(self.offsets_depth[l](self.scales_depth[l](self.box3d_depth[0](x))))
            size.append(self.scales_size[l](self.box3d_size[0](x)))
            conf.append(self.scales_conf[l](self.box3d_conf[0](x)))
        return quat, ctr, depth, size, conf


# --------------------------------------------------------------------------
# VoVNet V2 trunk with reference state-dict names (vovnet.py:100-330)
# --------------------------------------------------------------------------

class TorchDD3D(nn.Module):
    """Reference-named DD3D for the dd3d_kitti_dla34 experiment."""

    def __init__(self, num_classes=5, mean_depth=(32.594, 15.178, 8.424, 5.004, 4.662),
                 std_depth=(14.682, 7.139, 4.345, 2.399, 2.587)):
        super().__init__()
        strides = [8, 16, 32, 64, 128]
        dla = DLA([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512])
        self.backbone = FPN(dla, ["level3", "level4", "level5"],
                            {"level3": 128, "level4": 256, "level5": 512}, 256)
        self.fcos2d_head = FCOS2DHead(num_classes, 256, strides)
        self.fcos3d_head = FCOS3DHead(num_classes, 256, strides, mean_depth, std_depth)
        self.register_buffer("pixel_mean", torch.tensor([103.530, 116.280, 123.675]).view(1, 3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor([57.375, 57.120, 58.395]).view(1, 3, 1, 1))

    def forward(self, images_nchw):
        x = (images_nchw - self.pixel_mean) / self.pixel_std
        feats = self.backbone(x)
        features = [feats[f] for f in ("p3", "p4", "p5", "p6", "p7")]
        logits, box2d, ctr, _ = self.fcos2d_head(features)
        quat, pctr, depth, size, conf = self.fcos3d_head(features)
        return {
            "logits": logits, "box2d_reg": box2d, "centerness": ctr,
            "quat": quat, "proj_ctr": pctr, "depth": depth, "size": size, "conf": conf,
        }
