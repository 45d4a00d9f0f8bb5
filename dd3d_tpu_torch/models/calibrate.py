"""Static int8 calibration, counterpart of dd3d_tpu/models/calibrate.py.

Dynamic int8 (TPU.QUANT_INT8) takes one activation max|x| per quantized conv
per batch, an extra pass over each activation. `capture_scales` records
those maxima over calibration batches; inference with
TPU.QUANT_SCALES_PATH=<a JSON of them> uses each as a constant scale.

Capture: with `QuantSpec.capture` set, every eligible conv appends its
(scope path, "HxWxC" input tag, max|x|) during the forward, whatever
QUANT_MIN_CH is (models/layers.py), so calibration is the model's forward
plus a running max over batches and canvases. The scales JSON has the JAX
package's schema and keys, so one file serves both packages. The CLI is
`python -m dd3d_tpu_torch.calibrate_int8`.
"""
import atexit
import json
import os
import tempfile

import torch

from dd3d_tpu_torch.models.layers import quant_scope, quant_spec_from_cfg


def capture_scales(cfg, model, image_batches, plain: bool = False):
    """{conv_path: {shape_tag: act_amax}} (Python floats) over
    `image_batches`, each (B, H, W, 3) images (numpy or torch; moved to the
    model's device). Quantization is forced on with dynamic scales, so the
    observed activations follow the deployed (quantized-upstream) regime;
    the other TPU.QUANT_* keys are the caller's. `plain` runs the int8
    kernels' plain versions."""
    calib_cfg = cfg.clone()
    calib_cfg.TPU.QUANT_INT8 = True
    calib_cfg.TPU.QUANT_SCALES_PATH = ""  # dynamic scales during calibration
    spec = quant_spec_from_cfg(calib_cfg, plain=plain)
    model.eval()
    device = model.pixel_mean.device
    running, n = {}, 0
    for images in image_batches:
        spec.capture = []
        with torch.inference_mode(), quant_scope(spec):
            model(torch.as_tensor(images, device=device))
        amaxes = torch.stack([a for _, _, a in spec.capture]).tolist()  # one device sync a batch
        for (path, tag, _), amax in zip(spec.capture, amaxes):
            ent = running.setdefault(path, {})
            ent[tag] = max(amax, ent.get(tag, 0.0))
        n += 1
    if not running:
        raise ValueError("no calibration batches")
    n_sites = sum(len(v) for v in running.values())
    print(f"calibrated {len(running)} convs / {n_sites} (path, shape) sites over {n} batches")
    return running


def prepare_static_scales(cfg, model, image_batches, tag: str = "scales"):
    """Calibrate on `image_batches` and return a clone of cfg with the static
    scales in place (TPU.QUANT_INT8=True, TPU.QUANT_SCALES_PATH=<temp JSON>).
    Capture always runs with QUANT_MIN_CH=0, as the JAX package does
    (calibrate.py:97), so the scales serve any gate and the files of the two
    packages agree; the returned cfg keeps the caller's QUANT_MIN_CH. The
    temp file is removed at interpreter exit."""
    calib_cfg = cfg.clone()
    calib_cfg.TPU.QUANT_MIN_CH = 0
    scales = capture_scales(calib_cfg, model, image_batches)
    fd, path = tempfile.mkstemp(prefix=f"int8_{tag}_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(scales, f)
    atexit.register(lambda p=path: os.path.exists(p) and os.remove(p))
    out_cfg = cfg.clone()
    out_cfg.TPU.QUANT_INT8 = True
    out_cfg.TPU.QUANT_SCALES_PATH = path
    return out_cfg
