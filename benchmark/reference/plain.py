"""The plain reference of a DD3D configuration: the frozen reference model
built from the configuration file's sizes, its forward in f32 with TF32 off
in blocks of frames, its conv sites counted from the layer shapes, and the
fake quantization that stands in for a lower precision (the control).
Plain PyTorch; imports nothing of the program.
"""
import contextlib
import importlib
from typing import Dict, Iterator, List

import torch


def build(model_cfg: dict, device) -> torch.nn.Module:
    """The reference graph of `model_cfg` (a configuration file's "model"
    block) on `device`, in eval mode, from the builder module it names
    (`reference/<model_cfg["reference"]>.py`)."""
    builder = importlib.import_module(f"reference.{model_cfg['reference']}")
    with torch.device(device):
        model = builder.build(model_cfg)
    return model.to(device).eval()  # Scale / Offset make their scalars on the CPU


def strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward(model: torch.nn.Module, images_nhwc: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
    """Head outputs (per level, NCHW, f32) of uint8 BGR frames (B, H, W, 3)."""
    with torch.no_grad():
        return model(images_nhwc.permute(0, 3, 1, 2).float())


def conv_sites(model_cfg: dict, batch: int, height: int, width: int) -> List[dict]:
    """Every conv a forward of (batch, 3, height, width) runs, in order:
    name, input shape (NCHW), weight shape (OIHW), stride, padding, groups,
    and `input`, the same number for convs that read the same tensor.
    Counted on the meta device: shapes only, no arithmetic."""
    model = build(model_cfg, "meta")
    sites, inputs = [], []  # inputs are held, so no two of them share an id

    def hook(name):
        def record(mod, args):
            x = args[0]
            same = [i for i, t in enumerate(inputs) if t is x]
            if not same:
                inputs.append(x)
            sites.append({"name": name, "x": tuple(x.shape), "w": tuple(mod.weight.shape), "stride": mod.stride[0],
                          "pad": mod.padding[0], "groups": mod.groups, "input": same[0] if same else len(inputs) - 1})
        return record

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(torch.empty(batch, 3, height, width, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sites


def _convs(model, min_ch: int):
    return [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d) and m.in_channels >= min_ch]


def calibrate(model: torch.nn.Module, batches: Iterator[torch.Tensor], min_ch: int) -> Dict[tuple, torch.Tensor]:
    """{(conv name, input shape without the batch): max |x|} over `batches`
    of frames, for every conv of at least `min_ch` input channels: the
    static activation scales, worked out again from the calibration frames."""
    amax: Dict[tuple, torch.Tensor] = {}

    def hook(name):
        def record(mod, args):
            key = (name, tuple(args[0].shape[1:]))
            a = args[0].detach().abs().amax()
            amax[key] = torch.maximum(amax[key], a) if key in amax else a
        return record

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in _convs(model, min_ch)]
    try:
        for images in batches:
            forward(model, images)
    finally:
        for h in handles:
            h.remove()
    return amax


def fake_quant(x: torch.Tensor, amax: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(amax, min=1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


@contextlib.contextmanager
def quantized(model: torch.nn.Module, amax: Dict[tuple, torch.Tensor], bits: int, min_ch: int):
    """The model with every conv of at least `min_ch` input channels at
    `bits`: its input per tensor at the calibrated static scale, its weight
    per output channel (per-channel scaling commutes with a folded norm).
    Restores the f32 weights on exit."""
    saved, handles = {}, []

    def hook(name):
        def pre(mod, args):
            return (fake_quant(args[0], amax[(name, tuple(args[0].shape[1:]))], bits),)
        return pre

    try:
        with torch.no_grad():
            for name, m in _convs(model, min_ch):
                saved[name] = m.weight.detach().clone()
                w_amax = m.weight.abs().amax(dim=(1, 2, 3), keepdim=True)
                m.weight.copy_(fake_quant(m.weight, w_amax, bits))
                handles.append(m.register_forward_pre_hook(hook(name)))
        yield model
    finally:
        for h in handles:
            h.remove()
        with torch.no_grad():
            for name, m in _convs(model, min_ch):
                if name in saved:
                    m.weight.copy_(saved[name])

