"""The port's image reader and resize: PNG to BGR uint8 as
cv2.imread(path, IMREAD_COLOR) returns it, and the uint8 bilinear resize of
PIL's Image.resize(..., BILINEAR), byte for byte, with neither cv2 nor PIL.

Counterpart of dd3d_tpu/data/native/, which decodes with libpng and libjpeg.
The port builds without libpng's and libjpeg's headers, so the PNG decode
is split in two: the chunks are parsed and the IDAT stream inflated here with
Python's zlib (CRCs checked, as libpng does), and the five row filters are
undone in C++ (`csrc/imageio.cpp::png_unfilter_bgr`, built with g++ on first
use like the CUDA kernels, `kernels.load_library`), which also holds the
JAX package's Pillow-exact resize. zlib and the ctypes call both release the
GIL, so a thread pool decodes in parallel.

Supported: 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA PNGs (what
cv2 and the KITTI benchmark write); alpha is dropped, as IMREAD_COLOR drops
it. Other PNGs raise NotImplementedError. JPEG raises NotImplementedError:
real nuScenes frames are JPEGs (ROADMAP §1 item 12, a baseline decoder).

`write_png` writes BGR uint8 as an RGB PNG with zlib (the fixture of
`dd3d_tpu_torch/overfit_smoke.py`).
"""
import ctypes
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples a pixel

_u8p = ctypes.POINTER(ctypes.c_uint8)
_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from dd3d_tpu_torch.kernels import load_library

            lib = load_library("imageio.cpp")
            lib.png_unfilter_bgr.restype = ctypes.c_int32
            lib.png_unfilter_bgr.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                             ctypes.c_int32, _u8p]
            lib.resize_bilinear_u8.restype = ctypes.c_int32
            lib.resize_bilinear_u8.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
                                               ctypes.c_int32, ctypes.c_int32]
            lib.unfilter_resize_bgr.restype = ctypes.c_int32
            lib.unfilter_resize_bgr.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                                ctypes.c_int32, _u8p, ctypes.c_int32, ctypes.c_int32]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def png_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from the first 24 bytes of a PNG (its IHDR)."""
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    width, height = struct.unpack(">II", data[16:24])
    return height, width


def _check_format(data: bytes, what: str) -> None:
    if data[:3] == JPEG_SIGNATURE:
        raise NotImplementedError(f"{what}: JPEG decode is not ported; real nuScenes frames need it "
                                  "(ROADMAP §1 item 12)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")


def inflate_png(data: bytes, what: str = "image") -> Tuple[np.ndarray, int, int, int]:
    """(filtered scanlines as uint8, height, width, channels) of PNG bytes:
    the chunks walked with their CRCs checked, IDAT inflated."""
    _check_format(data, what)
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError(f"{what}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", data[crc_at: crc_at + 4])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{what}: PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos = crc_at + 4
    if header is None or not idat:
        raise ValueError(f"{what}: PNG without IHDR or IDAT")
    width, height, depth, color, _compression, _filter, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise NotImplementedError(f"{what}: PNG of bit depth {depth}, color type {color}, interlace "
                                  f"{interlace}; the port reads 8-bit non-interlaced gray, gray+alpha, RGB, RGBA")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    return raw, height, width, _CHANNELS[color]


def decode_bgr(data: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 3) uint8 BGR of PNG bytes, as cv2.imdecode(..., IMREAD_COLOR)."""
    return decode_resize_bgr(data, None, what)


def decode_resize_bgr(data: bytes, size: Optional[Tuple[int, int]], what: str = "image") -> np.ndarray:
    """PNG bytes decoded to BGR and resized to `size` = (new_h, new_w) as
    PIL's BILINEAR does (None: not resized), in one C call."""
    raw, h, w, c = inflate_png(data, what)
    dh, dw = size if size is not None else (h, w)
    out = np.empty((dh, dw, 3), np.uint8)
    rc = _library().unfilter_resize_bgr(_ptr(raw), raw.size, h, w, c, _ptr(out), dh, dw)
    if rc != 0:
        raise ValueError(f"{what}: PNG decode failed (code {rc})")
    return out


def read_image_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as cv2.imread(path, IMREAD_COLOR)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        raise FileNotFoundError(path)
    return decode_bgr(data, path)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """PIL-exact uint8 bilinear resize of an (H, W, 1) or (H, W, 3) image
    (PIL's modes L and RGB; it premultiplies the alpha of RGBA)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"need a uint8 (H, W, 1 or 3) image, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    out = np.empty((new_h, new_w, c), np.uint8)
    rc = _library().resize_bilinear_u8(_ptr(img), h, w, c, _ptr(out), new_h, new_w)
    if rc != 0:
        raise ValueError(f"resize of {img.shape} to ({new_h}, {new_w}) failed (code {rc})")
    return out


def decode_resize_batch(blobs: Sequence[bytes], targets: Sequence[Optional[Tuple[int, int]]],
                        executor=None) -> List[Optional[np.ndarray]]:
    """Decode and resize encoded images, each to its own (new_h, new_w)
    target (None skips it), through `executor` (a thread pool: zlib and the
    C call release the GIL) or in turn. Counterpart of the JAX package's
    OpenMP batch call (dd3d_tpu/data/native/__init__.py:204-231)."""
    def one(args):
        blob, target = args
        return None if target is None else decode_resize_bgr(blob, target)

    jobs = list(zip(blobs, targets))
    return list(executor.map(one, jobs)) if executor is not None else [one(j) for j in jobs]


def write_png(path: str, bgr: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 BGR image as an 8-bit RGB PNG, every row
    unfiltered, deflated at zlib `level` (cv2.imwrite's default is 1)."""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"need a uint8 (H, W, 3) image, got {bgr.dtype} {bgr.shape}")
    h, w, _ = bgr.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = bgr[:, :, ::-1].reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    png = (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
