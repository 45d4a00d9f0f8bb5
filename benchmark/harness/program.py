"""The system under test, and the one module of the harness that imports
it: the `dd3d_tpu_torch` package (never the JAX package beside it). Builds
the model of a configuration file with the weights the benchmark made, lets
the program derive what it derives (static int8 scales, folded norms), and
hands back the program's own serving entry and launch counters; and, for
the harness's faults, replaces the arguments of the program's NMS.
"""
import contextlib
import importlib
from typing import Callable, Dict


def _set(cfg, dotted: str, value):
    node = cfg
    *parents, leaf = dotted.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value


def _get(cfg, dotted: str):
    node = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def experiment_cfg(config: dict):
    """The program's config of a configuration file: the experiment, its
    overrides and dtype; then every number the file states of the model and
    the decode is checked against it, so the reference and the program
    cannot drift apart."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg(config["experiment"])
    for key, value in config.get("overrides", {}).items():
        _set(cfg, key, value)
    cfg.TPU.COMPUTE_DTYPE = config["dtype"]
    for key, value in config.get("stated", {}).items():
        have = _get(cfg, key)
        have = list(have) if isinstance(have, (list, tuple)) else have
        if have != value:
            raise ValueError(f"{config['name']}: the program's {key} is {have!r}, the configuration states {value!r}")
    return cfg


def build_server(config: dict, state_dict: Dict, calibration, device) -> Callable:
    """The program's serving entry for `config`, its weights loaded from the
    reference-named `state_dict` through the program's own renaming; with
    "static_int8" the program calibrates its static scales on the
    `calibration` batches (host frames)."""
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.calibrate import prepare_static_scales
    from dd3d_tpu_torch.models.postprocess import get_inference_fn
    from dd3d_tpu_torch.utils.convert_checkpoint import reference_to_port_names

    cfg = experiment_cfg(config)
    model = build_model(cfg).to(device)
    model.load_state_dict(reference_to_port_names(state_dict, model), strict=True)
    if config.get("static_int8"):
        cfg = prepare_static_scales(cfg, model, calibration)
    return get_inference_fn(model, cfg)


def counters(where: Dict[str, str]) -> Dict[str, int]:
    """The program's launch counters as they stand: {name: the `launches`
    attribute of "module:function"}, as the metric readers declare them."""
    out = {}
    for name, path in where.items():
        module, fn = path.split(":")
        out[name] = int(getattr(getattr(importlib.import_module(module), fn), "launches", 0))
    return out


@contextlib.contextmanager
def nms_arguments(change: Callable):
    """The program's class-aware NMS (`batched_nms_padded`, as its decode
    calls it) run on `change(boxes, scores, classes, iou_threshold)`."""
    from dd3d_tpu_torch.models import dd3d

    original = dd3d.batched_nms_padded

    def patched(boxes, scores, classes, iou_threshold, *args, **kwargs):
        return original(*change(boxes, scores, classes, iou_threshold), *args, **kwargs)

    dd3d.batched_nms_padded = patched
    try:
        yield
    finally:
        dd3d.batched_nms_padded = original
