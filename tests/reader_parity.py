"""What the JAX package's loader reads from image bytes, for the port's
reader tests (tests/test_torch_png.py, tests/test_torch_jpeg.py): its
`read_image_bgr` (the native reader, libpng/libjpeg, and cv2.imread where
that refuses) and its batch decode + resize (dd3d_tpu/data/build.py:168-183:
native.decode_resize_batch_multi, and for an image it refuses the per-image
fallback, read_image_bgr then ResizeTransform)."""
import os
import tempfile

import numpy as np

from dd3d_tpu_torch.data import imageio


def jax_read(data: bytes, suffix: str = ".img"):
    """dd3d_tpu.data.mapper.read_image_bgr of these bytes (through a
    temporary file), or None where it raises."""
    from dd3d_tpu.data.mapper import read_image_bgr

    fd, path = tempfile.mkstemp(suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        return read_image_bgr(path)
    except FileNotFoundError:
        return None
    finally:
        os.remove(path)


def jax_decode_resize(data: bytes, target):
    """The JAX loader's resized BGR image of these bytes at target (h, w)."""
    from dd3d_tpu.data import native
    from dd3d_tpu.data.augmentations import ResizeTransform

    got = native.decode_resize_batch_multi([data], [target])
    if got is not None and got[0] is not None:
        return got[0]
    img = jax_read(data)
    return None if img is None else ResizeTransform(*img.shape[:2], *target).apply_image(img)


def assert_reads_as_jax(data: bytes, what: str, targets=()):
    """The port's decode_bgr equals JAX's read_image_bgr byte for byte, and
    its decode_resize_batch JAX's batch path at each target (h, w); where
    JAX refuses the bytes, the port raises. Returns JAX's image or None."""
    want = jax_read(data)
    if want is None:
        try:
            imageio.decode_bgr(data, what)
        except (ValueError, NotImplementedError):
            return None
        raise AssertionError(f"{what}: the port decodes bytes the JAX reader refuses")
    got = imageio.decode_bgr(data, what)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), (
        f"{what}: max diff {np.abs(got.astype(int) - want).max() if got.shape == want.shape else got.shape}")
    if targets:
        got = imageio.decode_resize_batch([data] * len(targets), list(targets))
        for t, g in zip(targets, got):
            w = jax_decode_resize(data, t)
            assert g.shape == w.shape and g.tobytes() == w.tobytes(), f"{what}: resized to {t}"
    return want
