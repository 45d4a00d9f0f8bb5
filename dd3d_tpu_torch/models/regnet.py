"""RegNetY backbone, counterpart of dd3d_tpu/models/regnet.py: the trunk of
the dd3d_kitti_regnety_006_bifpn experiment (a dead config upstream, whose
feature extractor the JAX package implements from "Designing Network Design
Spaces", Radosavovic et al., CVPR 2020).

A 3x3/s2 stem of 32 channels, then four stages of residual Y-blocks (1x1
`a` -> 3x3 group conv `b`, stride 2 in a stage's first block -> squeeze-
excitation `se` -> 1x1 `c`, a 1x1 `proj` shortcut where the shape changes),
output strides 4/8/16/32 as `s1`..`s4`. Widths and depths are generated from
the (w0, wa, wm, depth) parameters, not tabled.

Module names are the flax scopes (`stem`, `s1_b0`, `a`, `b`, `se.fc1`, ...),
so the converter's rules pass them through. The SE convs are flax nn.Convs
with bias in the JAX package, which its int8 rule never reaches:
`PlainConv`. The group conv `b` is a ConvNorm with `groups` and quantizes
under TPU.QUANT_INT8 through the grouped int8 kernel.
"""
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dd3d_tpu_torch.models.layers import INIT_UNIFORM_FAN_IN, ConvNorm, PlainConv


def generate_regnet_params(w0: float, wa: float, wm: float, depth: int, group_w: int, q: int = 8
                           ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """Per-stage (widths, depths, group widths): u_j = w0 + wa * j quantized
    to a geometric ladder of ratio wm and rounded to multiples of q; equal
    neighbouring widths form a stage; each width is then made a multiple of
    its (possibly reduced) group width (dd3d_tpu/models/regnet.py:27-51)."""
    assert w0 > 0 and wa > 0 and wm > 1 and w0 % q == 0
    ws_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws_all = (np.round(w0 * np.power(wm, ks) / q) * q).astype(int)
    widths, depths = [], []
    for w in ws_all:
        if widths and widths[-1] == w:
            depths[-1] += 1
        else:
            widths.append(int(w))
            depths.append(1)
    gws = [min(group_w, w) for w in widths]
    widths = [int(round(w / g) * g) for w, g in zip(widths, gws)]
    return tuple(widths), tuple(depths), tuple(gws)


# (w0, wa, wm, depth, group_w, se_ratio): the paper's RegNetY table
REGNETY_SPECS = {
    "RegNetY-002": (24, 36.44, 2.49, 13, 8, 0.25),
    "RegNetY-004": (48, 27.89, 2.09, 16, 8, 0.25),
    "RegNetY-006": (48, 32.54, 2.32, 15, 16, 0.25),
    "RegNetY-008": (56, 38.84, 2.40, 14, 16, 0.25),
    "RegNetY-016": (48, 20.71, 2.65, 27, 24, 0.25),
    "RegNetY-032": (80, 42.63, 2.66, 21, 24, 0.25),
}

REGNET_STRIDES = {"s1": 4, "s2": 8, "s3": 16, "s4": 32}


class SqueezeExcite(nn.Module):
    """SE over the mean of H and W, taken in f32 and cast back to the
    activation dtype; `se_channels` comes from the block INPUT width."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.fc1 = PlainConv(channels, se_channels, 1, bias=True, init=INIT_UNIFORM_FAN_IN)
        self.fc2 = PlainConv(se_channels, channels, 1, bias=True, init=INIT_UNIFORM_FAN_IN)

    def forward(self, x):
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class YBlock(nn.Module):
    """Residual bottleneck of ratio 1 with a group conv and SE."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_w: int, se_ratio: float, norm: str):
        super().__init__()
        self.proj = ConvNorm(w_in, w_out, 1, stride, norm=norm) if w_in != w_out or stride != 1 else None
        self.a = ConvNorm(w_in, w_out, 1, 1, norm=norm, relu=True)
        self.b = ConvNorm(w_out, w_out, 3, stride, norm=norm, relu=True, groups=w_out // group_w)
        self.se = SqueezeExcite(w_out, max(1, int(round(w_in * se_ratio)))) if se_ratio > 0 else None
        self.c = ConvNorm(w_out, w_out, 1, 1, norm=norm)

    def forward(self, x):
        shortcut = x if self.proj is None else self.proj(x)
        y = self.b(self.a(x))
        if self.se is not None:
            y = self.se(y)
        return torch.relu(self.c(y) + shortcut)


class RegNet(nn.Module):
    """The trunk; returns a dict of the `out_features` among s1..s4."""

    def __init__(self, widths: Sequence[int], depths: Sequence[int], group_ws: Sequence[int], se_ratio: float = 0.25,
                 stem_w: int = 32, out_features: Sequence[str] = ("s2", "s3", "s4"), norm: str = "BN"):
        super().__init__()
        self.out_features = tuple(out_features)
        self.widths = tuple(widths)
        self.stem = ConvNorm(3, stem_w, 3, 2, norm=norm, relu=True)
        self.stages = []
        w_in = stem_w
        for si, (w, d, g) in enumerate(zip(widths, depths, group_ws)):
            blocks = []
            for bi in range(d):
                name = f"s{si + 1}_b{bi}"
                self.add_module(name, YBlock(w_in, w, 2 if bi == 0 else 1, g, se_ratio, norm))
                blocks.append(name)
                w_in = w
            self.stages.append(blocks)

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"s{i + 1}": w for i, w in enumerate(self.widths)}

    def forward(self, x):
        outputs = {}
        x = self.stem(x)
        for si, blocks in enumerate(self.stages):
            for name in blocks:
                x = getattr(self, name)(x)
            if f"s{si + 1}" in self.out_features:
                outputs[f"s{si + 1}"] = x
        return outputs


def build_regnet(name: str, norm: str, out_features=("s2", "s3", "s4")) -> RegNet:
    if name not in REGNETY_SPECS:
        raise KeyError(f"Unknown RegNetY variant {name!r}; known: {sorted(REGNETY_SPECS)}")
    w0, wa, wm, depth, group_w, se_ratio = REGNETY_SPECS[name]
    widths, depths, gws = generate_regnet_params(w0, wa, wm, depth, group_w)
    return RegNet(widths, depths, gws, se_ratio=se_ratio, out_features=out_features, norm=norm)
