"""Write the JPEG fixtures of this directory with cv2 (libjpeg-turbo), and
digests.json: the SHA-256 and shape of each file's BGR decode by the JAX
package's native reader (dd3d_tpu.data.native.decode_bgr, libjpeg), which
cv2.imdecode equals wherever cv2 decodes the file (it refuses the truncated
one). A machine without cv2 or libjpeg cannot encode JPEGs, so the GPU
checks (chip_smoke.py phase 42, tests/test_torch_cuda.py) decode these files
with the port's reader and hold them to the digests; tests/test_torch_jpeg.py
holds the digests to native and cv2. From the repo root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/data/jpeg/make_fixtures.py
"""
import hashlib
import json
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLINGS = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
FRAME = "frame_900x1600.jpg"  # a nuScenes camera's size, 4:2:0 at quality 90


def scene(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A camera-like BGR frame: smooth gradients, blurred texture, a few
    flat boxes with sharp edges."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([90 + 60 * xx / w, 80 + 70 * yy / h, 120 + 40 * np.sin(xx / 37.0 + yy / 53.0)], -1)
    texture = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.float32), (0, 0), 2.5)
    img += (texture - 128) * 1.6
    for _ in range(max(2, h * w // 40000)):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        img[y0: y0 + rng.randint(4, h // 3 + 5), x0: x0 + rng.randint(4, w // 3 + 5)] = rng.randint(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img: np.ndarray, quality: int = 90, sampling: str = "420", **flags) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    params += [v for k, on in flags.items() for v in (getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), int(on))]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def with_exif_orientation(data: bytes, orientation: int = 6) -> bytes:
    """`data` with an EXIF APP1 segment after SOI whose one IFD entry is the
    Orientation tag (6: rotate 90 degrees clockwise to display)."""
    ifd = struct.pack(">H", 1) + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0)
    body = b"Exif\x00\x00" + b"MM\x00\x2a" + struct.pack(">I", 8) + ifd
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def fixtures():
    """{file name: JPEG bytes}."""
    rng = np.random.RandomState(0)
    small = scene(rng, 183, 322)
    out = {f"sampling_{s}.jpg": encode(small, 90, s) for s in SAMPLINGS}
    out["restart_3.jpg"] = encode(small, 75, "420", rst_interval=3)
    out["progressive.jpg"] = encode(small, 90, "420", progressive=True)
    out["gray.jpg"] = encode(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY), 90)
    out["exif_orientation_6.jpg"] = with_exif_orientation(encode(small, 90, "420"))
    whole = encode(small, 90, "422", rst_interval=2)
    out["truncated.jpg"] = whole[: len(whole) * 3 // 5]
    out[FRAME] = encode(scene(rng, 900, 1600), 90, "420")
    return out


def main():
    from dd3d_tpu.data import native

    digests = {}
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        bgr = native.decode_bgr(data)
        assert bgr is not None, name
        digests[name] = {"sha256": hashlib.sha256(bgr.tobytes()).hexdigest(), "shape": list(bgr.shape)}
        print(f"{name}: {len(data)} bytes, {bgr.shape}")
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        f.write("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}" for k, v in sorted(digests.items()))
                + "\n}\n")


if __name__ == "__main__":
    main()
