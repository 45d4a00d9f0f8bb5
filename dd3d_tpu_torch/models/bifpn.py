"""BiFPN (EfficientDet, Tan et al., CVPR 2020), counterpart of
dd3d_tpu/models/bifpn.py, and the RegNetY + BiFPN feature extractor of the
dd3d_kitti_regnety_006_bifpn experiment (`build_fcos_regnety_bifpn_backbone`).

The trunk's C3-C5 enter through 1x1 ConvNorm projections `proj_s2..s4`;
P6 and P7 are 3x3/s2 max-pools of the projected C5 and of P6. Each of
NUM_REPEATS cells `cell{r}` fuses top-down, then bottom-up: a fusion
`{name}_w` (relu'd scalar weights over their sum) and a separable conv
`{name}_conv` (depthwise 3x3 `dw`, then the 1x1 ConvNorm `pw` with swish).
Inside a cell, downsampling is the same max-pool and upsampling nearest 2x.

The depthwise `dw` is an unfolded FoldableConv in the JAX package: it has
no norm and no bias, and quantizes only under TPU.QUANT_UNFOLDED, through
the grouped int8 kernel (groups = channels).

The reference never had this extractor, so no reference-named checkpoint
exists for it: the port loads its own checkpoints and the JAX package's
variables (utils/convert_checkpoint.convert_flax_variables), and a
reference-named `.pth` raises (training/checkpoint.load_weights).
"""
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dd3d_tpu_torch.models import register_backbone
from dd3d_tpu_torch.models.fpn import _upsample_nearest_2x
from dd3d_tpu_torch.models.layers import INIT_UNIFORM_FAN_IN, ConvNorm, FoldableConv
from dd3d_tpu_torch.models.regnet import REGNET_STRIDES, build_regnet


def maxpool_s2(x: torch.Tensor) -> torch.Tensor:
    """flax's max_pool(x, (3, 3), (2, 2), padding="SAME"): ceil(side / 2)
    outputs, the pad of (out - 1) * 2 + 3 - side split with the smaller half
    BEFORE: (0, 1) on an even side, (1, 1) on an odd one, filled with -inf.
    F.max_pool2d's padding=1 pads 1 on both sides and picks other windows on
    an even side."""
    pads = []
    for side in (x.shape[3], x.shape[2]):  # F.pad's order: last dim first
        total = max((-(-side // 2) - 1) * 2 + 3 - side, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class SepConvBN(nn.Module):
    """Depthwise 3x3 `dw` (no bias) + pointwise 1x1 ConvNorm `pw` (+ swish)."""

    def __init__(self, in_channels: int, features: int, norm: str, activation: bool = True):
        super().__init__()
        self.dw = FoldableConv(in_channels, in_channels, 3, groups=in_channels, init=INIT_UNIFORM_FAN_IN)
        self.pw = ConvNorm(in_channels, features, 1, norm=norm, init=INIT_UNIFORM_FAN_IN, swish=activation)

    def forward(self, x):
        return self.pw(self.dw(x))


class Fuse(nn.Module):
    """Fast normalized fusion: relu(w) / (sum relu(w) + 1e-4) in f32, cast
    to the inputs' dtype, then sum_i w_i x_i in that dtype in order from 0,
    as Python's `sum` runs it in the JAX module. Its parameter is flax's `w`
    (`params_by_name`: the converter keeps the leaf name)."""

    params_by_name = True

    def __init__(self, n: int):
        super().__init__()
        self.w = nn.Parameter(torch.ones(n))

    def forward(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        w = torch.relu(self.w)
        w = (w / (w.sum() + 1e-4)).to(inputs[0].dtype)
        out = 0
        for i, x in enumerate(inputs):
            out = out + w[i] * x
        return out


# (fused node, the inputs it reads): top-down, then bottom-up
# (dd3d_tpu/models/bifpn.py:79-88); "up:" marks nearest 2x, "pool:" the max-pool
_CELL_NODES = (
    ("p6_td", ("p6", "up:p7")),
    ("p5_td", ("p5", "up:p6_td")),
    ("p4_td", ("p4", "up:p5_td")),
    ("p3_out", ("p3", "up:p4_td")),
    ("p4_out", ("p4", "p4_td", "pool:p3_out")),
    ("p5_out", ("p5", "p5_td", "pool:p4_out")),
    ("p6_out", ("p6", "p6_td", "pool:p5_out")),
    ("p7_out", ("p7", "pool:p6_out")),
)


class BiFPNCell(nn.Module):
    def __init__(self, channels: int, norm: str):
        super().__init__()
        for name, inputs in _CELL_NODES:
            self.add_module(f"{name}_w", Fuse(len(inputs)))
            self.add_module(f"{name}_conv", SepConvBN(channels, channels, norm))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        nodes = dict(zip(("p3", "p4", "p5", "p6", "p7"), feats))
        for name, inputs in _CELL_NODES:
            xs = []
            for key in inputs:
                op, _, src = key.rpartition(":")
                x = nodes[src]
                xs.append(_upsample_nearest_2x(x) if op == "up" else maxpool_s2(x) if op == "pool" else x)
            nodes[name] = getattr(self, f"{name}_conv")(getattr(self, f"{name}_w")(xs))
        return [nodes[k] for k in ("p3_out", "p4_out", "p5_out", "p6_out", "p7_out")]


class BiFPN(nn.Module):
    """Trunk C3..C5 -> BiFPN P3..P7; returns a dict of `p{k}` features."""

    no_reference_checkpoint = ("the RegNetY + BiFPN feature extractor has no reference checkpoint (the reference's "
                               "regnety_006_bifpn builder never existed): load a checkpoint directory of the port "
                               "or the JAX package's variables (convert_flax_variables)")

    def __init__(self, bottom_up: nn.Module, in_features: Sequence[str], in_strides: Dict[str, int],
                 in_channels: Dict[str, int], out_channels: int = 160, num_repeats: int = 3, norm: str = "BN"):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.in_strides = {f: in_strides[f] for f in self.in_features}
        self.out_channels = out_channels
        for f in self.in_features:
            self.add_module(f"proj_{f}", ConvNorm(in_channels[f], out_channels, 1, norm=norm,
                                                  init=INIT_UNIFORM_FAN_IN))
        self.cells = [f"cell{r}" for r in range(num_repeats)]
        for name in self.cells:
            self.add_module(name, BiFPNCell(out_channels, norm))

    @property
    def out_feature_strides(self) -> Dict[str, int]:
        s0 = min(self.in_strides.values())
        return {f"p{(s0 * 2 ** i).bit_length() - 1}": s0 * 2 ** i for i in range(5)}

    @property
    def out_features(self) -> Tuple[str, ...]:
        return tuple(sorted(self.out_feature_strides, key=self.out_feature_strides.get))

    @property
    def size_divisibility(self) -> int:
        return max(self.out_feature_strides.values())

    def forward(self, x):
        trunk = self.bottom_up(x)
        feats = [getattr(self, f"proj_{f}")(trunk[f]) for f in self.in_features]
        p6 = maxpool_s2(feats[-1])
        feats = feats + [p6, maxpool_s2(p6)]
        for name in self.cells:
            feats = getattr(self, name)(feats)
        return dict(zip(self.out_features, feats))


@register_backbone("build_fcos_regnety_bifpn_backbone")
def build_fcos_regnety_bifpn_backbone(cfg) -> BiFPN:
    """RegNetY (FE.BACKBONE.NAME, NORM) + BiFPN (FE.BIFPN: OUT_CHANNELS,
    NUM_REPEATS, NORM) at P3-P7; size divisibility 128."""
    trunk = build_regnet(cfg.FE.BACKBONE.NAME, cfg.FE.BACKBONE.NORM)
    bifpn = cfg.FE.get("BIFPN", {})
    in_features = ("s2", "s3", "s4")
    return BiFPN(trunk, in_features, REGNET_STRIDES, trunk.out_channels,
                 out_channels=int(bifpn.get("OUT_CHANNELS", 160)), num_repeats=int(bifpn.get("NUM_REPEATS", 3)),
                 norm=bifpn.get("NORM", "BN"))
