"""The reference graph of a DD3D configuration on DLA-34 with the P6P7 FPN:
the frozen `TorchDD3D`, sized from the configuration file's "model" block.
A configuration names its graph's builder module ("model": {"reference":
...}); another graph is another module beside this one."""
import torch

from reference.ref_model import TorchDD3D


def build(model_cfg: dict) -> torch.nn.Module:
    if (model_cfg["meta_architecture"], model_cfg["backbone"], model_cfg["fpn_top"]) != ("DD3D", "DLA-34", "p6p7"):
        raise ValueError(f"the DLA-34 reference cannot build {model_cfg}")
    return TorchDD3D(num_classes=model_cfg["num_classes"], mean_depth=tuple(model_cfg["mean_depth_per_level"]),
                     std_depth=tuple(model_cfg["std_depth_per_level"]))
