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
