"""On-device color jitter, counterpart of dd3d_tpu/ops/color_jitter.py: the
mapper samples three blend weights per image and the train step applies
brightness -> saturation -> contrast, each clipped to [0, 255]."""
import torch

# BGR grayscale weights
_GRAY_BGR = (0.114, 0.587, 0.299)


def apply_color_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) BGR in [0, 255], any dtype; factors (B, 3) =
    (brightness, saturation, contrast) weights, 1 = identity. Returns f32."""
    x = images.float()
    wb, ws, wc = (factors.float()[:, i, None, None, None] for i in range(3))
    x = torch.clamp(x * wb, 0.0, 255.0)
    gray = (x @ torch.tensor(_GRAY_BGR, device=x.device))[..., None]
    x = torch.clamp((1.0 - ws) * gray + ws * x, 0.0, 255.0)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((1.0 - wc) * mean + wc * x, 0.0, 255.0)
