"""Seeded weights for the reference-named DD3D graph, made on the device.

`make_state_dict` fills every tensor of a reference state dict from one
`torch.Generator` on the given device, in one large draw a kind of tensor,
so set-up costs a few kernel launches and no host work. The scheme is the
test suite's detection conditioning (tests/torch_port_util.py
`condition_for_detection`), with the Scale / Offset scalars kept at their
initial values as `chip_smoke.randomize_state` keeps them:
- conv weights He-scaled, N(0, 2 / fan_in), so features carry the image
  through the depth;
- the predictors' weights N(0, 3e-6), so the logits are one or two units
  wide and the kept scores lie well below 1 (at the tests' 1e-5 the
  kept 3D scores of some seeds saturate at 1, where no gap can show);
- norm scales 1 + N(0, 0.1), norm biases, running means and conv biases
  N(0, 0.1), running variances U(0.5, 1);
- the 2D box regression's bias + 4, so 2D boxes span a few strides and the
  NMS has overlaps to resolve.
Both sides of the comparison load the same tensors: the program through its
own loader, the reference as they are.
"""
from typing import Dict

import torch

PREDICTORS = ("cls_logits", "box2d_reg", "centerness", "box3d_quat", "box3d_ctr", "box3d_depth", "box3d_size",
              "box3d_conf", "attr_logits", "speed")
KEEP = ("pixel_mean", "pixel_std", "mean_depth_per_level", "std_depth_per_level")


def _kind(name: str, t: torch.Tensor) -> str:
    leaf = name.rsplit(".", 1)[-1]
    parts = name.split(".")
    if leaf == "num_batches_tracked" or leaf in KEEP:
        return "keep"
    if any(p.startswith(("scales_", "offsets_")) for p in parts):
        return "keep"  # Scale / Offset: stride and depth-statistic inits
    if t.dim() == 4:
        return "predictor" if any(p in PREDICTORS for p in parts) else "conv"
    if leaf == "running_var":
        return "var"
    if leaf == "weight" and "norm" in parts:
        return "norm_scale"
    return "small"  # norm biases, running means, conv biases


def make_state_dict(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} shaped like `template` (a reference
    model's state dict, on any device, meta included), drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    groups: Dict[str, list] = {}
    for name, t in template.items():
        groups.setdefault(_kind(name, t), []).append(name)
    out = {}
    for kind in ("conv", "predictor", "norm_scale", "small", "var"):
        names = groups.get(kind, [])
        if not names:
            continue
        sizes = [template[n].numel() for n in names]
        if kind == "var":
            flat = torch.rand(sum(sizes), generator=gen, device=device) * 0.5 + 0.5
        else:
            flat = torch.randn(sum(sizes), generator=gen, device=device)
        for name, chunk in zip(names, torch.split(flat, sizes)):
            shape = template[name].shape
            value = chunk.view(shape)
            if kind == "conv":
                value = value * (2.0 / float(shape[1] * shape[2] * shape[3])) ** 0.5
            elif kind == "predictor":
                value = value * 3e-6
            elif kind == "norm_scale":
                value = 1.0 + 0.1 * value
            elif kind == "small":
                value = 0.1 * value
            out[name] = value
    for name in groups.get("keep", []):
        t = template[name]
        if t.is_meta:
            raise ValueError(f"{name} has no value on the meta device; build the template on a real device")
        out[name] = t.detach().to(device).clone()
    bias = "fcos2d_head.box2d_reg.bias"
    out[bias] = out[bias] + 4.0
    return out
