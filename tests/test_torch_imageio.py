"""The port's image reader and resize (dd3d_tpu_torch/data/imageio.py, its C++
in csrc/imageio.cpp) against what the JAX package reads and resizes with:

- decode byte-identical to cv2.imread(path, IMREAD_COLOR) on PNGs that cv2
  writes (gray, RGB, RGBA; libpng's adaptive filters, every zlib strategy)
  and on PNGs written here with each of the five row filters alone, whose
  filter bytes are checked;
- the resize byte-identical to PIL's Image.resize(..., BILINEAR) on up- and
  downscales, 1 and 3 channels (the JAX package's uint8 path,
  dd3d_tpu/data/augmentations.py:61-78);
- `png_size` from the header equals the decoded shape; a JPEG decodes as
  cv2 decodes it (the decoder's own tests: tests/test_torch_jpeg.py), an
  arithmetic-coded JPEG and a 16-bit PNG as the JAX package reads them
  (tests/test_torch_png.py holds the PNG kinds), a broken CRC raises
  ValueError;
- `write_png` read back by cv2; the port's make_fixture (pixels, calib,
  labels, split) equal to scripts/overfit_smoke.py::make_fixture's.
"""
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dd3d_tpu_torch.data import imageio


def noisy_image(rng, shape):
    """Noise with a smooth patch and a flat one, so that libpng's adaptive
    filtering picks several filter types."""
    img = rng.randint(0, 256, shape, dtype=np.uint8)
    h, w = shape[:2]
    ramp = (np.arange(w)[None, :] * 3 + np.arange(h)[:, None] * 5) % 256
    img[: h // 2, : w // 2] = (ramp[: h // 2, : w // 2] if img.ndim == 2 else ramp[: h // 2, : w // 2, None])
    img[h // 2:, w // 2:] = 17
    return img


@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 31), (16, 9, 4), (61, 70, 3)])
@pytest.mark.parametrize("strategy", [0, 1, 2, 3, 4])
def test_decode_equals_cv2_imread(tmp_path, shape, strategy):
    img = noisy_image(np.random.RandomState(sum(shape) + strategy), shape)
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_STRATEGY, strategy])
    got = imageio.read_image_bgr(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    with open(path, "rb") as f:
        assert imageio.png_size(f.read(24)) == want.shape[:2]


def filtered_rows(raw: np.ndarray, bpp: int, ftype: int) -> bytes:
    """PNG scanlines of `raw` (H, W*C) uint8, every row with filter `ftype`
    (PNG specification, section 9), written out in numpy."""
    h, stride = raw.shape
    a = raw.astype(np.int64)
    left = np.zeros_like(a)
    left[:, bpp:] = a[:, :-bpp]
    up = np.zeros_like(a)
    up[1:] = a[:-1]
    upleft = np.zeros_like(a)
    upleft[1:, bpp:] = a[:-1, :-bpp]
    if ftype == 0:
        out = a
    elif ftype == 1:
        out = a - left
    elif ftype == 2:
        out = a - up
    elif ftype == 3:
        out = a - (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out = a - pred
    rows = np.concatenate([np.full((h, 1), ftype), out % 256], axis=1).astype(np.uint8)
    return rows.tobytes()


def write_png_with_filter(path, img: np.ndarray, ftype: int):
    """An 8-bit PNG of `img` (gray, or RGB/RGBA in that channel order), every
    row with one filter type."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = filtered_rows(img.reshape(h, w * c), c, ftype)
    with open(path, "wb") as f:
        f.write(imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(data, 6)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_row_filter_equals_cv2_imread(tmp_path, channels, ftype):
    rng = np.random.RandomState(10 * channels + ftype)
    img = noisy_image(rng, (23, 29) if channels == 1 else (23, 29, channels))
    path = str(tmp_path / "f.png")
    write_png_with_filter(path, img, ftype)
    raw, h, w, c = imageio.inflate_png(open(path, "rb").read())
    assert (h, w, c) == (23, 29, channels) and set(raw.reshape(h, -1)[:, 0].tolist()) == {ftype}
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None and want.shape == (23, 29, 3)
    assert imageio.read_image_bgr(path).tobytes() == want.tobytes()


@pytest.mark.parametrize("size", [(288, 954), (576, 1908), (100, 33), (375, 1242), (64, 1300), (500, 100)])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_pil_bilinear(size, channels):
    rng = np.random.RandomState(channels)
    img = noisy_image(rng, (375, 1242, channels))
    pil = Image.fromarray(img[:, :, 0] if channels == 1 else img)
    want = np.asarray(pil.resize((size[1], size[0]), Image.BILINEAR)).reshape(size[0], size[1], channels)
    got = imageio.resize_bilinear(img, *size)
    assert got.tobytes() == want.tobytes()


def test_decode_resize_and_batch(tmp_path):
    rng = np.random.RandomState(5)
    paths, imgs = [], []
    for i, shape in enumerate([(40, 90, 3), (33, 47, 3)]):
        imgs.append(noisy_image(rng, shape))
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], imgs[-1])
    blobs = [open(p, "rb").read() for p in paths]
    out = imageio.decode_resize_batch(blobs, [(20, 45), None])
    assert out[1] is None
    assert out[0].tobytes() == imageio.resize_bilinear(imgs[0], 20, 45).tobytes()
    assert imageio.decode_resize_bgr(blobs[1], (66, 94)).tobytes() == imageio.resize_bilinear(imgs[1], 66, 94).tobytes()


def test_refuses_what_it_does_not_read(tmp_path):
    """A JPEG is read (tests/test_torch_jpeg.py holds the decoder) as
    cv2.imdecode reads it; Huffman data under an arithmetic-coding frame
    header decodes as the JAX package's native reader decodes it, and a
    16-bit PNG as the cv2.imread it falls back to (tests/test_torch_png.py).
    A corrupt CRC, other bytes and a missing file raise."""
    from tests.reader_parity import assert_reads_as_jax

    _, jpeg = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    assert imageio.decode_bgr(jpeg.tobytes()).tobytes() == cv2.imdecode(jpeg, cv2.IMREAD_COLOR).tobytes()
    arithmetic = jpeg.tobytes().replace(b"\xff\xc0", b"\xff\xc9", 1)
    assert assert_reads_as_jax(arithmetic, "arithmetic-coded JPEG") is not None
    _, png16 = cv2.imencode(".png", np.full((8, 8, 3), 0x1234, np.uint16))
    assert (assert_reads_as_jax(png16.tobytes(), "16-bit PNG") == 0x12).all()
    path = str(tmp_path / "c.png")
    imageio.write_png(path, np.zeros((4, 5, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 1  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        imageio.decode_bgr(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.png_size(b"GIF89a" + bytes(18))
    with pytest.raises(FileNotFoundError):
        imageio.read_image_bgr(str(tmp_path / "missing.png"))


def test_write_png_reads_back_with_cv2(tmp_path):
    img = noisy_image(np.random.RandomState(2), (31, 45, 3))
    path = str(tmp_path / "w.png")
    imageio.write_png(path, img)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED).tobytes() == img.tobytes()


def test_make_fixture_equals_the_jax_scripts(tmp_path):
    """8 images (n_images > 4 varies the pose): the same files, the same
    pixels as cv2 reads them."""
    from scripts.overfit_smoke import make_fixture as jax_make_fixture

    from dd3d_tpu_torch.overfit_smoke import make_fixture

    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_make_fixture(a, n_images=8)
    make_fixture(b, n_images=8)
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    assert sum(f.endswith(".png") for f in files) == 8
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".png"):
            assert cv2.imread(pb).tobytes() == cv2.imread(pa).tobytes(), f
            assert imageio.read_image_bgr(pb).tobytes() == cv2.imread(pa).tobytes(), f
        else:
            assert open(pa).read() == open(pb).read(), f
