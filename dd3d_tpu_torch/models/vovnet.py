"""VoVNet V2 backbone (One-Shot Aggregation + eSE), counterpart of
dd3d_tpu/models/vovnet.py: a stem of stride 4, then stages 2..5 of OSA
blocks, the V-99-eSE preset of the KITTI and nuScenes V2-99 experiments
among them.

Module names follow the JAX package's flax scopes (`stem1`, `OSA3_2`,
`layer0`, `concat`, `ese.fc`, `conv_reduction`, `dw` / `pw`), so the flax
path of every tensor is its port name with "/" for "." (the converter's
rules pass them through unchanged). The reference checkpoints name them
with slashes (`stem.stem_1/conv.weight`), which no nn.Module name can hold:
`utils/convert_checkpoint.reference_to_port_names` renames them.

The eSE `fc` and the depthwise `dw` are flax nn.Convs in the JAX package,
so they stay in the compute dtype under TPU.QUANT_INT8 (`PlainConv`).
"""
import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models import register_backbone
from dd3d_tpu_torch.models.fpn import fpn_from_cfg
from dd3d_tpu_torch.models.layers import INIT_UNIFORM_FAN_IN, ConvNorm, PlainConv

# name -> spec; dd3d_tpu/models/vovnet.py:18-40
VOVNET_SPECS = {
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

VOVNET_STRIDES = {"stem": 4, "stage2": 4, "stage3": 8, "stage4": 16, "stage5": 32}


def hsigmoid(x):
    """relu6(x + 3) / 6, each step rounded in the dtype of x, as JAX writes
    it (F.hardsigmoid rounds once)."""
    return F.relu6(x + 3.0) / 6.0


class ESEModule(nn.Module):
    """Effective squeeze-excitation: the mean over H and W in the compute
    dtype, a 1x1 conv with bias, the hsigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = PlainConv(channels, channels, 1, bias=True, init=INIT_UNIFORM_FAN_IN)

    def forward(self, x):
        return x * hsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class DWConvBlock(nn.Module):
    """Depthwise 3x3 (groups = channels, no bias), then a 1x1 ConvNorm and
    relu."""

    def __init__(self, channels: int, norm: str):
        super().__init__()
        self.dw = PlainConv(channels, channels, 3, groups=channels, init=INIT_UNIFORM_FAN_IN)
        self.pw = ConvNorm(channels, channels, 1, norm=norm, relu=True)

    def forward(self, x):
        return self.pw(self.dw(x))


class OSAModule(nn.Module):
    """One-shot aggregation: a chain of `layer_per_block` convs, the block's
    input and every link concatenated, a 1x1 `concat` ConvNorm, eSE, and
    the input added back when `identity`. A depthwise block whose input
    width is not `stage_ch` first reduces it with a 1x1 `conv_reduction`."""

    def __init__(self, in_ch: int, stage_ch: int, concat_ch: int, layer_per_block: int, identity: bool,
                 depthwise: bool, norm: str):
        super().__init__()
        self.identity = identity
        self.conv_reduction = (ConvNorm(in_ch, stage_ch, 1, norm=norm, relu=True)
                               if depthwise and in_ch != stage_ch else None)
        ch = stage_ch if self.conv_reduction is not None else in_ch
        self.layers = []
        for i in range(layer_per_block):
            layer = DWConvBlock(stage_ch, norm) if depthwise else ConvNorm(ch, stage_ch, 3, norm=norm, relu=True)
            self.add_module(f"layer{i}", layer)
            self.layers.append(f"layer{i}")
            ch = stage_ch
        self.concat = ConvNorm(in_ch + layer_per_block * stage_ch, concat_ch, 1, norm=norm, relu=True)
        self.ese = ESEModule(concat_ch)

    def forward(self, x):
        outputs = [x]
        y = x if self.conv_reduction is None else self.conv_reduction(x)
        for name in self.layers:
            y = getattr(self, name)(y)
            outputs.append(y)
        out = self.ese(self.concat(torch.cat(outputs, dim=1)))
        return out + x if self.identity else out


class VoVNet(nn.Module):
    """VoVNet V2 trunk; returns a dict of the `out_features` among `stem`
    and `stage2`..`stage5` (strides 4, 4, 8, 16, 32). Every OSA block runs
    eSE (the reference's SE flag is dead code), blocks after the first of a
    stage add their input, and stages 3-5 start with torch's
    MaxPool2d(3, 2, ceil_mode=True), the pooling the JAX package writes as
    bottom/right padding of (dim - 3) % 2."""

    def __init__(self, variant: str, out_features=("stage3", "stage4", "stage5"), norm: str = "BN"):
        super().__init__()
        spec = VOVNET_SPECS[variant]
        self.out_features = tuple(out_features)
        stem = spec["stem"]
        self.stem1 = ConvNorm(3, stem[0], 3, 2, norm=norm, relu=True)
        self.stem2 = ConvNorm(stem[0], stem[1], 3, 1, norm=norm, relu=True)
        self.stem3 = ConvNorm(stem[1], stem[2], 3, 2, norm=norm, relu=True)
        self.stages = []
        in_ch = stem[2]
        for i in range(4):
            blocks = []
            for b in range(spec["block_per_stage"][i]):
                name = f"OSA{i + 2}_{b + 1}"
                self.add_module(name, OSAModule(in_ch, spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                                                spec["layer_per_block"], identity=b > 0,
                                                depthwise=spec.get("dw", False), norm=norm))
                blocks.append(name)
                in_ch = spec["stage_out_ch"][i]
            self.stages.append(blocks)

    def forward(self, x):
        outputs = {}
        x = self.stem3(self.stem2(self.stem1(x)))
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i, blocks in enumerate(self.stages):
            if i > 0:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for name in blocks:
                x = getattr(self, name)(x)
            if f"stage{i + 2}" in self.out_features:
                outputs[f"stage{i + 2}"] = x
        return outputs


def _vovnet_fpn(cfg, top_block: str):
    name = cfg.FE.BACKBONE.NAME
    if name not in VOVNET_SPECS:
        raise NotImplementedError(f"FE.BACKBONE.NAME={name!r} is not a VoVNet preset; presets: {sorted(VOVNET_SPECS)}")
    spec = VOVNET_SPECS[name]
    channels = {"stem": spec["stem"][2], **{f"stage{i + 2}": spec["stage_out_ch"][i] for i in range(4)}}
    trunk = VoVNet(name, out_features=tuple(cfg.FE.BACKBONE.OUT_FEATURES), norm=cfg.FE.BACKBONE.NORM)
    return fpn_from_cfg(cfg, trunk, channels, VOVNET_STRIDES, top_block)


@register_backbone("build_fcos_vovnet_fpn_backbone_p6")
def build_fcos_vovnet_fpn_backbone_p6(cfg):
    """VoVNet + FPN + P6 top level (strides 8..64); the V2-99 backbone."""
    return _vovnet_fpn(cfg, "p6")


@register_backbone("build_vovnet_fpn_backbone")
def build_vovnet_fpn_backbone(cfg):
    """VoVNet + FPN + max-pool top level (strides 8..64)."""
    return _vovnet_fpn(cfg, "maxpool")
