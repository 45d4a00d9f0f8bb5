"""The one traffic generator: a traffic file's parameters and a seed in,
the requests of a run out, the same for the same seed.

A serving mix ("mode": "serve") is a pool of `pool` distinct batches of
`batch` frames, cycled by the closed loop. A frame is `frame` (h, w)
resized so its short side is `min_size_test`, as the test loader resizes
it, placed at the top left of a zero `canvas`
(the loader's padding to the backbone's multiple). Its intrinsics are the
mix's `intrinsics` scaled by the same factor. A frame's pixels are a sum
of random fields at the scales `structure` lists ([cell in pixels,
weight]: uniform noise on a grid of that cell, bilinearly upsampled), so
frames carry structure from blobs to single pixels, and what a model sees
differs from frame to frame as a camera's frames do; uniform noise alone
averages out over a receptive field, and a random model's detections then
hardly depend on the frame. The fields are drawn on the device and the
frames copied to the host a batch at a time: a request is host frames, as
the loader hands them over. `contrast` stretches the sum about mid-grey (a
mean of fields is flatter than each), clipped to the 8 bits.
"""
import hashlib
from typing import Dict, List

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 1


def resized(frame, min_size: int):
    h, w = frame
    s = min_size / min(h, w)
    return int(round(h * s)), int(round(w * s)), s


def serve_pool(traffic: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """`pool` batches: {"images": (B, H, W, 3) uint8 BGR, "intrinsics":
    (B, 3, 3) f32}."""
    b, pool = int(traffic["batch"]), int(traffic["pool"])
    canvas_h, canvas_w = traffic["canvas"]
    h, w, s = resized(traffic["frame"], int(traffic["min_size_test"]))
    if h > canvas_h or w > canvas_w:
        raise ValueError(f"a {h}x{w} frame does not fit the {canvas_h}x{canvas_w} canvas")
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "frames"))
    weights = sum(weight for _, weight in traffic["structure"])
    frames = np.zeros((pool, b, canvas_h, canvas_w, 3), np.uint8)
    for p in range(pool):  # a batch at a time, so set-up holds no more than a batch of fields
        field = torch.zeros((b, 3, h, w), device=device)
        for cell, weight in traffic["structure"]:
            grid = torch.rand((b, 3, -(-h // cell), -(-w // cell)), generator=gen, device=device)
            field += weight * torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
        field = 0.5 + float(traffic["contrast"]) * (field / weights - 0.5)
        pixels = (field * 255.0).round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        frames[p, :, :h, :w] = pixels.cpu().numpy()
        del field, pixels
    k = np.array(traffic["intrinsics"], np.float64)
    k[:2] *= s
    batch_k = np.tile(k.astype(np.float32), (b, 1, 1))
    return [{"images": frames[p], "intrinsics": batch_k} for p in range(pool)]
