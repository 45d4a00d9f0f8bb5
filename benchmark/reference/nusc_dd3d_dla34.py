"""The reference graph of DD3D's nuScenes configuration on DLA-34 with the
P6P7 FPN: the frozen `TorchDD3D` plus NuscenesDD3D's attribute logits and
ReLU'd speed, 3x3 convs on each level's cls-tower output at the root, as
the reference names them (`attr_logits.*`, `speed.*`). Copied from
tests/torch_ref_nusc.py's `TorchNuscenesDD3D`; plain PyTorch, imports
nothing of the program."""
import torch.nn.functional as F
from torch import nn

from reference.ref_model import TorchDD3D


class TorchNuscenesDD3D(TorchDD3D):
    """Reference-named NuscenesDD3D on DLA-34 + FPN P3-P7."""

    def __init__(self, num_classes, mean_depth, std_depth, max_attr):
        super().__init__(num_classes=num_classes, mean_depth=mean_depth, std_depth=std_depth)
        self.attr_logits = nn.Conv2d(256, max_attr, 3, 1, 1)
        self.speed = nn.Conv2d(256, 1, 3, 1, 1)

    def forward(self, images_nchw):
        x = (images_nchw - self.pixel_mean) / self.pixel_std
        feats = self.backbone(x)
        features = [feats[f] for f in ("p3", "p4", "p5", "p6", "p7")]
        logits, box2d, ctr, towers = self.fcos2d_head(features)
        quat, pctr, depth, size, conf = self.fcos3d_head(features)
        return {
            "logits": logits, "box2d_reg": box2d, "centerness": ctr,
            "quat": quat, "proj_ctr": pctr, "depth": depth, "size": size, "conf": conf,
            "attr_logits": [self.attr_logits(c) for c in towers],
            "speed": [F.relu(self.speed(c)) for c in towers],
        }


def build(model_cfg: dict) -> nn.Module:
    if (model_cfg["meta_architecture"], model_cfg["backbone"], model_cfg["fpn_top"]) != ("NuscenesDD3D", "DLA-34",
                                                                                        "p6p7"):
        raise ValueError(f"the nuScenes DLA-34 reference cannot build {model_cfg}")
    return TorchNuscenesDD3D(model_cfg["num_classes"], tuple(model_cfg["mean_depth_per_level"]),
                             tuple(model_cfg["std_depth_per_level"]), model_cfg["max_num_attributes"])
