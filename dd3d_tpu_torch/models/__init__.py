"""Model registry: meta-architectures and backbone builders, keyed by the same
config strings as dd3d_tpu/models/__init__.py (`MODEL.META_ARCHITECTURE`,
`FE.BUILDER`). A key the port has no builder for raises NotImplementedError."""
from typing import Optional

import torch

META_ARCH_REGISTRY = {}
BACKBONE_REGISTRY = {}


def register_meta_arch(name):
    def deco(fn):
        META_ARCH_REGISTRY[name] = fn
        return fn

    return deco


def register_backbone(name):
    def deco(fn):
        BACKBONE_REGISTRY[name] = fn
        return fn

    return deco


def build_feature_extractor(cfg):
    """Resolve `cfg.FE.BUILDER`."""
    import dd3d_tpu_torch.models.bifpn  # noqa: F401  (populates the registry)
    import dd3d_tpu_torch.models.dla  # noqa: F401
    import dd3d_tpu_torch.models.vovnet  # noqa: F401

    builder = BACKBONE_REGISTRY.get(cfg.FE.BUILDER)
    if builder is None:
        raise NotImplementedError(f"FE.BUILDER={cfg.FE.BUILDER!r} is not ported; ported: {sorted(BACKBONE_REGISTRY)}")
    return builder(cfg)


def build_model(cfg, generator: Optional[torch.Generator] = None):
    """Resolve `cfg.MODEL.META_ARCHITECTURE` to an nn.Module in eval mode,
    on the CPU. With `generator`, every conv weight is drawn from it."""
    import dd3d_tpu_torch.models.dd3d  # noqa: F401
    import dd3d_tpu_torch.models.dense_depth  # noqa: F401
    import dd3d_tpu_torch.models.nuscenes_dd3d  # noqa: F401

    builder = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE)
    if builder is None:
        raise NotImplementedError(
            f"MODEL.META_ARCHITECTURE={cfg.MODEL.META_ARCHITECTURE!r} is not ported; "
            f"ported: {sorted(META_ARCH_REGISTRY)}"
        )
    model = builder(cfg)
    if generator is not None:
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
    return model.eval()
