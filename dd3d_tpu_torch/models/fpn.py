"""Feature Pyramid Network, counterpart of dd3d_tpu/models/fpn.py: 1x1
laterals + 3x3 outputs, nearest-neighbour top-down upsampling, sum fusion
(the only FE.FPN.FUSE_TYPE any config uses), and the RetinaNet-style P6P7
top on the P5 output (P7 reads relu(P6))."""
from typing import Dict, Sequence

import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models.layers import INIT_UNIFORM_FAN_IN, ConvNorm, FoldableConv


def _upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class LastLevelP6P7(nn.Module):
    """P6 = conv3x3/s2(P5), P7 = conv3x3/s2(relu(P6)); both with bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = FoldableConv(channels, channels, 3, stride=2, bias=True, init=INIT_UNIFORM_FAN_IN)
        self.p7 = FoldableConv(channels, channels, 3, stride=2, bias=True, init=INIT_UNIFORM_FAN_IN)

    def forward(self, p5):
        p6 = self.p6(p5)
        return p6, self.p7(F.relu(p6))


class FPN(nn.Module):
    """FPN over a bottom-up trunk; returns a dict of `p{k}` features. Only the
    "p6p7" top block (the KITTI DLA-34 backbone) is ported."""

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str], in_channels: Dict[str, int],
                 in_strides: Dict[str, int], out_channels: int = 256, norm: str = "",
                 fuse_type: str = "sum"):
        super().__init__()
        if fuse_type != "sum":
            raise NotImplementedError(f"FE.FPN.FUSE_TYPE={fuse_type!r} is not ported")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.in_strides = dict(in_strides)
        for f in self.in_features:
            idx = self.in_strides[f].bit_length() - 1
            self.add_module(f"fpn_lateral{idx}", ConvNorm(in_channels[f], out_channels, 1, norm=norm,
                                                          init=INIT_UNIFORM_FAN_IN))
            self.add_module(f"fpn_output{idx}", ConvNorm(out_channels, out_channels, 3, norm=norm,
                                                         init=INIT_UNIFORM_FAN_IN))
        self.top_block = LastLevelP6P7(out_channels)

    @property
    def out_feature_strides(self) -> Dict[str, int]:
        strides = {f"p{self.in_strides[f].bit_length() - 1}": self.in_strides[f] for f in self.in_features}
        max_s = max(self.in_strides.values())
        for s in (max_s * 2, max_s * 4):
            strides[f"p{s.bit_length() - 1}"] = s
        return strides

    @property
    def out_features(self):
        return tuple(sorted(self.out_feature_strides, key=self.out_feature_strides.get))

    @property
    def size_divisibility(self) -> int:
        return max(self.out_feature_strides.values())

    def forward(self, x):
        trunk_feats = self.bottom_up(x)
        results, prev = {}, None
        for f in reversed(self.in_features):
            idx = self.in_strides[f].bit_length() - 1
            lateral = getattr(self, f"fpn_lateral{idx}")(trunk_feats[f])
            if prev is not None:
                lateral = lateral + _upsample_nearest_2x(prev)
            prev = lateral
            results[f"p{idx}"] = getattr(self, f"fpn_output{idx}")(lateral)
        max_idx = max(self.in_strides.values()).bit_length() - 1
        results[f"p{max_idx + 1}"], results[f"p{max_idx + 2}"] = self.top_block(results[f"p{max_idx}"])
        return results
