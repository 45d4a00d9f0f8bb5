"""Feature Pyramid Network, counterpart of dd3d_tpu/models/fpn.py: 1x1
laterals + 3x3 outputs, nearest-neighbour top-down upsampling, sum or avg
fusion (FE.FPN.FUSE_TYPE; avg halves the sum of the lateral and the
top-down path), and one of the JAX package's three top blocks, all on the
P5 *output*:
- "p6p7" (RetinaNet's LastLevelP6P7; the KITTI DLA-34 backbone): P6 =
  conv3x3/s2(P5), P7 = conv3x3/s2(relu(P6));
- "p6" (LastLevelP6; the V2-99 backbone): P6 = conv3x3/s2(P5), no relu;
- "maxpool" (detectron2's LastLevelMaxPool): a 1x1 window with stride 2.
The top convs are plain convs in the JAX package (flax nn.Conv,
dd3d_tpu/models/fpn.py:108-117), so they never quantize under
TPU.QUANT_INT8: the port builds them as `PlainConv`."""
from typing import Dict, Sequence

import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models.layers import INIT_UNIFORM_FAN_IN, ConvNorm, PlainConv
from dd3d_tpu_torch.utils.profiling import annotate


def _upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _top_conv(channels: int) -> PlainConv:
    return PlainConv(channels, channels, 3, stride=2, bias=True, init=INIT_UNIFORM_FAN_IN)


class LastLevelP6P7(nn.Module):
    """P6 = conv3x3/s2(P5), P7 = conv3x3/s2(relu(P6)); both with bias."""

    levels = 2  # extra levels above the trunk's last

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = _top_conv(channels)
        self.p7 = _top_conv(channels)

    def forward(self, p5):
        p6 = self.p6(p5)
        return p6, self.p7(F.relu(p6))


class LastLevelP6(nn.Module):
    """P6 = conv3x3/s2(P5), with bias and no relu after it."""

    levels = 1

    def __init__(self, channels: int):
        super().__init__()
        self.p6 = _top_conv(channels)

    def forward(self, p5):
        return (self.p6(p5),)


class LastLevelMaxPool(nn.Module):
    """A 1x1 max-pool with stride 2: every second row and column of P5."""

    levels = 1

    def __init__(self, channels: int):
        super().__init__()

    def forward(self, p5):
        return (F.max_pool2d(p5, 1, 2),)


TOP_BLOCKS = {"p6p7": LastLevelP6P7, "p6": LastLevelP6, "maxpool": LastLevelMaxPool}


class FPN(nn.Module):
    """FPN over a bottom-up trunk; returns a dict of `p{k}` features."""

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str], in_channels: Dict[str, int],
                 in_strides: Dict[str, int], out_channels: int, norm: str, fuse_type: str, top_block: str):
        super().__init__()
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FE.FPN.FUSE_TYPE={fuse_type!r}")
        self.bottom_up = bottom_up
        self.reads_frames = getattr(bottom_up, "reads_frames", False)  # models/dd3d.py DD3D.forward
        self.in_features = tuple(in_features)
        self.in_strides = dict(in_strides)
        self.out_channels = out_channels
        self.fuse_type = fuse_type
        for f in self.in_features:
            idx = self.in_strides[f].bit_length() - 1
            self.add_module(f"fpn_lateral{idx}", ConvNorm(in_channels[f], out_channels, 1, norm=norm,
                                                          init=INIT_UNIFORM_FAN_IN))
            self.add_module(f"fpn_output{idx}", ConvNorm(out_channels, out_channels, 3, norm=norm,
                                                         init=INIT_UNIFORM_FAN_IN))
        self.top_block = TOP_BLOCKS[top_block](out_channels)

    @property
    def out_feature_strides(self) -> Dict[str, int]:
        strides = {f"p{self.in_strides[f].bit_length() - 1}": self.in_strides[f] for f in self.in_features}
        max_s = max(self.in_strides.values())
        for i in range(1, self.top_block.levels + 1):
            strides[f"p{(max_s << i).bit_length() - 1}"] = max_s << i
        return strides

    @property
    def out_features(self):
        return tuple(sorted(self.out_feature_strides, key=self.out_feature_strides.get))

    @property
    def size_divisibility(self) -> int:
        return max(self.out_feature_strides.values())

    def forward(self, x):
        with annotate("forward.backbone"):
            trunk_feats = self.bottom_up(x)
        with annotate("forward.fpn"):
            results, prev = {}, None
            for f in reversed(self.in_features):
                idx = self.in_strides[f].bit_length() - 1
                lateral = getattr(self, f"fpn_lateral{idx}")(trunk_feats[f])
                if prev is not None:
                    lateral = lateral + _upsample_nearest_2x(prev)
                    if self.fuse_type == "avg":
                        lateral = lateral / 2.0
                prev = lateral
                results[f"p{idx}"] = getattr(self, f"fpn_output{idx}")(lateral)
            max_idx = max(self.in_strides.values()).bit_length() - 1
            for i, p in enumerate(self.top_block(results[f"p{max_idx}"]), start=1):
                results[f"p{max_idx + i}"] = p
        return results


def fpn_from_cfg(cfg, bottom_up: nn.Module, channels: Dict[str, int], strides: Dict[str, int],
                 top_block: str) -> FPN:
    """The FPN of cfg.FE.FPN (IN_FEATURES, OUT_CHANNELS, NORM, FUSE_TYPE) over
    `bottom_up`, whose features have `channels` and `strides`."""
    fpn = cfg.FE.FPN
    return FPN(bottom_up=bottom_up, in_features=tuple(fpn.IN_FEATURES),
               in_channels={f: channels[f] for f in fpn.IN_FEATURES},
               in_strides={f: strides[f] for f in fpn.IN_FEATURES}, out_channels=fpn.OUT_CHANNELS,
               norm=fpn.NORM, fuse_type=fpn.FUSE_TYPE, top_block=top_block)
