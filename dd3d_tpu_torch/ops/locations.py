"""FCOS feature-location grids, counterpart of dd3d_tpu/ops/locations.py."""
import torch


def compute_feature_locations(h: int, w: int, stride: int, offset: str = "none",
                              device=None, dtype=torch.float32) -> torch.Tensor:
    """(h * w, 2) grid of (x, y) pixel coordinates, row-major over (y, x).
    With offset "none" there is no half-stride shift."""
    shift_x = torch.arange(0, w * stride, stride, dtype=dtype, device=device)
    shift_y = torch.arange(0, h * stride, stride, dtype=dtype, device=device)
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")  # each (h, w)
    locations = torch.stack([sx.reshape(-1), sy.reshape(-1)], dim=1)
    if offset == "half":
        locations = locations + stride // 2
    elif offset != "none":
        raise ValueError(offset)
    return locations


def _linspace_f32(stop: int, num: int, device=None) -> torch.Tensor:
    """jnp.linspace(0.0, stop, num) in f32 as JAX computes it: step = i / (num
    - 1) in f32, then 0 * (1 - step) + stop * step, the last point stop
    itself. torch.linspace steps from both ends and rounds some points
    differently."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    stop_t = torch.tensor([float(stop)], dtype=torch.float32, device=device)
    return torch.cat([stop_t * step, stop_t])


def aligned_bilinear(x: torch.Tensor, factor: int, offset: str = "none") -> torch.Tensor:
    """Aligned bilinear upsample of an NCHW tensor by an integer factor, the
    counterpart of dd3d_tpu/ops/locations.py::aligned_bilinear (itself
    tridet/utils/tensor2d.py:28-47): replicate-pad one pixel at the bottom
    and right, sample an align_corners grid of factor * side + 1 points with
    JAX's f32 linspace and its gather-and-blend order, crop the last row and
    column (and with offset "half" first shift by factor // 2, edge-padded)."""
    if factor < 1 or int(factor) != factor:
        raise ValueError(f"factor must be a positive integer; got {factor}")
    if factor == 1:
        return x
    h, w = x.shape[2], x.shape[3]
    x = torch.nn.functional.pad(x, (0, 1, 0, 1), mode="replicate")
    oh, ow = factor * h + 1, factor * w + 1
    ys, xs = _linspace_f32(h, oh, x.device), _linspace_f32(w, ow, x.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w)
    y1, x1 = torch.clamp(y0 + 1, 0, h), torch.clamp(x0 + 1, 0, w)
    wy = (ys - y0.to(ys.dtype))[:, None]
    wx = (xs - x0.to(xs.dtype))[None, :]
    g00 = x[:, :, y0][:, :, :, x0]
    g01 = x[:, :, y0][:, :, :, x1]
    g10 = x[:, :, y1][:, :, :, x0]
    g11 = x[:, :, y1][:, :, :, x1]
    out = g00 * (1 - wy) * (1 - wx) + g01 * (1 - wy) * wx + g10 * wy * (1 - wx) + g11 * wy * wx
    if offset == "half":
        out = torch.nn.functional.pad(out, (factor // 2, 0, factor // 2, 0), mode="replicate")
    elif offset != "none":
        raise ValueError(offset)
    return out[:, :, :oh - 1, :ow - 1]
