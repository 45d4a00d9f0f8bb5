"""The port's image reader and resize: PNG and JPEG to BGR uint8 as the JAX
package's `read_image_bgr` returns them (its native reader: libpng's
simplified API for a PNG, libjpeg-turbo 2.1.5 for a JPEG; cv2.imread for the
files that reader refuses), and the uint8 bilinear resize of PIL's
Image.resize(..., BILINEAR), byte for byte, with neither cv2 nor PIL.

Counterpart of dd3d_tpu/data/native/, which decodes with libpng and libjpeg.
The port builds without libpng's and libjpeg's headers. The PNG decode is
split in two: the chunks are parsed here (CRCs checked, as libpng does; the
colour chunks gAMA, sRGB, iCCP and cHRM followed through libpng's colour
space rules to the gamma table its simplified read applies) and the IDAT
stream inflated with Python's zlib; the row filters, Adam7, the sample
formats and the table are undone in C++ (`csrc/imageio.cpp::png_decode_bgr`,
built with g++ on first use like the CUDA kernels, `kernels.load_library`),
which also holds the JAX package's Pillow-exact resize. A JPEG is decoded
whole in that C++ (`jpeg_decode_resize_bgr`, its own decoder with
libjpeg-turbo's arithmetic). zlib and the ctypes calls release the GIL, so
a thread pool decodes in parallel. Formats are told apart by their magic
bytes.

Read, PNG: every colour type and bit depth, non-interlaced and Adam7;
palette and low-bit gray expanded, alpha and tRNS dropped (IMREAD_COLOR
drops them; the native reader decodes BGRA and drops alpha), 8-bit samples
gamma-corrected as libpng corrects them, a 16-bit sample's high byte with no
gamma (cv2.imread's, which the JAX reader falls back to: its native reader
refuses 16-bit files). JPEG: sequential and progressive, Huffman and
arithmetic coding, 8-bit, gray, 3 or 4 components (CMYK/YCCK through cv2's
own conversion, as cv2.imread reads them), any integral sampling factors,
restart intervals; a progressive file whose scans leave coefficient bits
unsent is smoothed as libjpeg-turbo 2.1.5 smooths it; a truncated file
reads on into jpeg_mem_src's fake EOI marker, as libjpeg reads it; the
IDCT is libjpeg-turbo's x86-64 SIMD form, so corrupt data decodes as it
does. An EXIF orientation is applied where cv2.imread applies it (the files
the JAX reader hands to cv2: 4-component JPEGs, 16-bit PNGs) and ignored
elsewhere, as the native reader ignores it; a CMYK/YCCK file that needs
smoothing is smoothed as cv2's libjpeg-turbo 3.1.2 smooths it. Not read,
raising NotImplementedError naming the kind: lossless, hierarchical and
12/16-bit JPEGs, fractional sampling ratios, 2 or more than 4 components
(both JAX sides refuse all of them). Other bytes raise ValueError.

`write_png` writes BGR uint8 as an RGB PNG with zlib (the fixture of
`dd3d_tpu_torch/overfit_smoke.py`).
"""
import ctypes
import math
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# JPEG frame headers: SOF0-SOF15 but DHT (C4), JPG (C8) and DAC (CC).
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
_JPEG_PARAMETERLESS = frozenset(range(0xD0, 0xD8)) | {0x01}  # RSTn, TEM
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples a pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # png_handle_IHDR

_u8p = ctypes.POINTER(ctypes.c_uint8)
_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from dd3d_tpu_torch.kernels import load_library

            lib = load_library("imageio.cpp")
            lib.png_decode_resize_bgr.restype = ctypes.c_int32
            lib.png_decode_resize_bgr.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                                  ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
                                                  ctypes.c_char_p, _u8p, ctypes.c_int32, ctypes.c_int32]
            lib.resize_bilinear_u8.restype = ctypes.c_int32
            lib.resize_bilinear_u8.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
                                               ctypes.c_int32, ctypes.c_int32]
            lib.jpeg_decode_resize_bgr.restype = ctypes.c_int32
            lib.jpeg_decode_resize_bgr.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _u8p,
                                                   ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
                                                   ctypes.c_int32]
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


class TruncatedHeader(ValueError):
    """The bytes end before the header that holds the image's size."""


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a JPEG's frame header (SOFn), walking the marker
    segments before it (APPn segments, EXIF's among them, may come first).
    Raises TruncatedHeader when `data` ends before the frame header."""
    if data[:3] != JPEG_SIGNATURE:
        raise ValueError("not a JPEG file")
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:  # bytes between segments, skipped as libjpeg skips them
            pos += 1
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            raise TruncatedHeader("JPEG data ends before its frame header")
        marker = data[pos]
        pos += 1
        if marker in _JPEG_PARAMETERLESS or marker == 0:
            continue
        if marker in (0xD9, 0xDA):
            raise ValueError("JPEG without a frame header (SOF) before its scan")
        if pos + 7 > n:
            raise TruncatedHeader("JPEG data ends before its frame header")
        if marker in _JPEG_SOF:
            height, width = struct.unpack(">HH", data[pos + 3: pos + 7])
            if height == 0 or width == 0:
                raise ValueError(f"JPEG of size {height}x{width}")
            return height, width
        pos += struct.unpack(">H", data[pos: pos + 2])[0]


def _exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of a TIFF-format EXIF block's first IFD,
    as cv2's ExifReader reads it (modules/imgcodecs/src/exif.cpp: the first
    entry of the tag wins, entries read before a read past the block's end
    stand); 1 where there is none."""
    if tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    orientation = None
    try:
        if struct.unpack(e + "H", tiff[2:4])[0] != 0x2A:
            return 1
        offset = struct.unpack(e + "I", tiff[4:8])[0]
        for i in range(struct.unpack(e + "H", tiff[offset: offset + 2])[0]):
            at = offset + 2 + 12 * i
            if struct.unpack(e + "H", tiff[at: at + 2])[0] == 0x0112 and orientation is None:
                orientation = struct.unpack(e + "H", tiff[at + 8: at + 10])[0]
    except struct.error:
        pass
    return 1 if orientation is None else orientation


def cv2_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8; 1 leaves the image as it is) that
    cv2.imread applies to bytes the JAX package's native reader refuses and
    hands to cv2: a 4-component (CMYK/YCCK) JPEG, whose first APP1 segment
    before its scan cv2 reads past 6 bytes; a 16-bit PNG, whose first eXIf
    chunk it reads. 1 for every other file, which the native reader decodes
    without turning it."""
    if data[:3] == JPEG_SIGNATURE:
        pos, n, app1, components = 2, len(data), None, 0
        while pos + 4 <= n:
            if data[pos] != 0xFF:
                pos += 1
                continue
            marker = data[pos + 1]
            if marker in _JPEG_PARAMETERLESS or marker in (0x00, 0xFF):
                pos += 1 + (marker != 0xFF)
                continue
            if marker in (0xD9, 0xDA):
                break
            end = pos + 2 + struct.unpack(">H", data[pos + 2: pos + 4])[0]
            if marker == 0xE1 and app1 is None:
                app1 = data[pos + 4: end]
            if marker in _JPEG_SOF and pos + 9 < n:
                components = data[pos + 9]
            pos = end
        return _exif_orientation(app1[6:]) if components == 4 and app1 is not None and len(app1) > 6 else 1
    if data[:8] == PNG_SIGNATURE and len(data) >= 29 and data[24] == 16:
        pos = 8
        while pos + 8 <= len(data):
            length, kind = struct.unpack(">I4s", data[pos: pos + 8])
            if kind == b"eXIf" and length >= 2 and data[pos + 8: pos + 10] in (b"II", b"MM"):
                return _exif_orientation(data[pos + 8: pos + 8 + length])
            if kind == b"IEND":
                break
            pos += 12 + length
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ApplyExifOrientation (modules/imgcodecs/src/loadsave.cpp) of an
    (H, W, C) image."""
    if orientation >= 5 and orientation <= 8:
        img = img.transpose(1, 0, 2)
    flips = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1), slice(None, None, -1)),
             4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
             7: (slice(None, None, -1), slice(None, None, -1)), 8: (slice(None, None, -1),)}
    if orientation in flips:
        img = img[flips[orientation]]
    return np.ascontiguousarray(img)


def oriented_image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of the image the JAX package's reader returns for
    these bytes: image_size's, turned where cv2.imread turns the image."""
    h, w = image_size(data)
    return (w, h) if 5 <= cv2_orientation(data) <= 8 else (h, w)


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of PNG or JPEG bytes, from the header; counterpart of
    dd3d_tpu.data.native.image_dims. Raises ValueError for other bytes."""
    if data[:8] == PNG_SIGNATURE:
        return png_size(data)
    if data[:3] == JPEG_SIGNATURE:
        return jpeg_size(data)
    raise ValueError("not a PNG or JPEG file")


def read_image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file, reading only as far as its
    header (a PNG's first 24 bytes; a JPEG's segments up to its SOFn)."""
    with open(path, "rb") as f:
        data = f.read(4096)
        while True:
            try:
                return image_size(data)
            except TruncatedHeader:
                more = f.read(max(len(data), 4096))
                if not more:
                    raise
                data += more


def _check_png(data: bytes, what: str) -> None:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG or JPEG file")


# libpng 1.6's fixed-point gamma arithmetic (png.c), in its own doubles
PNG_FP_1 = 100000
PNG_GAMMA_sRGB_INVERSE = 45455  # the file gamma of sRGB
PNG_GAMMA_sRGB = 220000  # the screen gamma png_image_finish_read sets (PNG_DEFAULT_sRGB)
PNG_GAMMA_THRESHOLD_FIXED = 5000  # pnglibconf.h


def _png_muldiv(a: int, times: int, divisor: int) -> Optional[int]:
    """png_muldiv: a * times / divisor, rounded; None on overflow."""
    if a == 0 or times == 0:
        return 0
    r = math.floor(float(a) * times / divisor + .5)
    return r if -2147483648 <= r <= 2147483647 else None


def _png_gamma_significant(g: int) -> bool:
    return g < PNG_FP_1 - PNG_GAMMA_THRESHOLD_FIXED or g > PNG_FP_1 + PNG_GAMMA_THRESHOLD_FIXED


# png_sRGB_checks (png.c): the ICC profiles libpng takes for sRGB, as
# (adler32, crc32, length, MD5 of the header, intent).
_SRGB_PROFILES = (
    (0x0a3fd9f6, 0x3b8772b9, 3048, (0x29f83dde, 0xaff255ae, 0x7842fae4, 0xca83390d), 0),
    (0x4909e5e1, 0x427ebb21, 3052, (0xc95bd637, 0xe95d8a3b, 0x0df38f99, 0xc1320389), 1),
    (0xfd2144a1, 0x306fd8ae, 60988, (0xfc663378, 0x37e2886b, 0xfd72e983, 0x8228f1b8), 0),
    (0x209c35d2, 0xbbef7812, 60960, (0x34562abf, 0x994ccd06, 0x6d2c5721, 0xd0d68c5d), 0),
    (0xa054d762, 0x5d5129ce, 3024, (0, 0, 0, 0), 1),
    (0xf784f3fb, 0x182ea552, 3144, (0, 0, 0, 0), 0),
    (0x0398f3fc, 0xf29e526d, 3144, (0, 0, 0, 0), 1))
_SRGB_XY = (31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)  # white, red, green, blue x, y


def _endpoints_match(a, b, delta: int) -> bool:  # png_colorspace_endpoints_match
    return all(abs(x - y) <= delta for x, y in zip(a, b))


def _png_check_xy(xy) -> int:
    """png_colorspace_check_xy (png.c): 0 when libpng can turn the cHRM
    chromaticities (white, red, green, blue x and y) into XYZ end points and
    back within 5, 1 when it cannot, 2 for its internal error."""
    wx, wy, rx, ry, gx, gy, bx, by = xy

    def muldiv(a, times, divisor):
        return None if divisor == 0 else _png_muldiv(a, times, divisor)

    def reciprocal(a):
        r = math.floor(1e10 / a + .5)
        return r if -2147483648 <= r <= 2147483647 else 0

    for x, y, lo in ((rx, ry, 0), (gx, gy, 0), (bx, by, 0), (wx, wy, 5)):  # png_XYZ_from_xy
        if x < 0 or x > PNG_FP_1 or y < lo or y > PNG_FP_1 - x:
            return 1
    left, right = muldiv(gx - bx, ry - by, 7), muldiv(gy - by, rx - bx, 7)
    if left is None or right is None:
        return 2
    denominator = left - right
    left, right = muldiv(gx - bx, wy - by, 7), muldiv(gy - by, wx - bx, 7)
    if left is None or right is None:
        return 2
    red_inverse = muldiv(wy, denominator, left - right)
    if red_inverse is None or red_inverse <= wy:
        return 1
    left, right = muldiv(ry - by, wx - bx, 7), muldiv(rx - bx, wy - by, 7)
    if left is None or right is None:
        return 2
    green_inverse = muldiv(wy, denominator, left - right)
    if green_inverse is None or green_inverse <= wy:
        return 1
    blue_scale = reciprocal(wy) - reciprocal(red_inverse) - reciprocal(green_inverse)
    if blue_scale <= 0:
        return 1
    xyz = [muldiv(rx, PNG_FP_1, red_inverse), muldiv(ry, PNG_FP_1, red_inverse),
           muldiv(PNG_FP_1 - rx - ry, PNG_FP_1, red_inverse), muldiv(gx, PNG_FP_1, green_inverse),
           muldiv(gy, PNG_FP_1, green_inverse), muldiv(PNG_FP_1 - gx - gy, PNG_FP_1, green_inverse),
           muldiv(bx, blue_scale, PNG_FP_1), muldiv(by, blue_scale, PNG_FP_1),
           muldiv(PNG_FP_1 - bx - by, blue_scale, PNG_FP_1)]
    if any(v is None for v in xyz):
        return 1
    test, white_x, white_y, d_white = [], 0, 0, 0  # png_xy_from_XYZ
    for X, Y, Z in (xyz[0:3], xyz[3:6], xyz[6:9]):
        d = X + Y + Z
        x, y = muldiv(X, PNG_FP_1, d), muldiv(Y, PNG_FP_1, d)
        if x is None or y is None:
            return 1
        test += [x, y]
        d_white, white_x, white_y = d_white + d, white_x + X, white_y + Y
    x, y = muldiv(white_x, PNG_FP_1, d_white), muldiv(white_y, PNG_FP_1, d_white)
    if x is None or y is None:
        return 1
    return 0 if _endpoints_match([x, y] + test, xy, 5) else 1


class _Colorspace:
    """png_colorspace as libpng 1.6's reader fills it from gAMA, sRGB, iCCP
    and cHRM (pngrutil.c png_handle_*, png.c png_colorspace_*): the file
    gamma and whether the colour information was found inconsistent, which
    makes libpng skip the colour chunks after it."""

    def __init__(self, color: int):
        self.color = color
        self.gamma = 0
        self.have_gamma = self.from_gama = self.from_srgb = self.have_intent = False
        self.have_endpoints = self.from_chrm = self.invalid = False
        self.endpoints = None

    def _check_gamma(self, gamma: int, source: str) -> bool:  # png_colorspace_check_gamma
        if self.have_gamma:
            gtest = _png_muldiv(self.gamma, PNG_FP_1, gamma)
            if gtest is None or _png_gamma_significant(gtest):
                if self.from_srgb or source == "sRGB":
                    return source == "sRGB"
                return source == "gAMA"
        return True

    def gama(self, body: bytes) -> None:
        if len(body) != 4:
            return
        g = struct.unpack(">I", body)[0]
        g = -1 if g > 0x7FFFFFFF else g  # png_get_fixed_point's error value
        if g < 16 or g > 625000000 or self.from_gama:
            self.invalid = True  # out of range, or a second gAMA
        elif not self.invalid and self._check_gamma(g, "gAMA"):
            self.gamma, self.have_gamma, self.from_gama = g, True, True

    def set_srgb(self, intent: int) -> None:  # png_colorspace_set_sRGB
        if self.invalid:
            return
        if intent < 0 or intent >= 4:
            self.invalid = True
            return
        if self.from_srgb:
            return
        self.have_intent = self.have_endpoints = self.have_gamma = self.from_srgb = True
        self.endpoints = _SRGB_XY
        self.gamma = PNG_GAMMA_sRGB_INVERSE

    def srgb(self, body: bytes) -> None:
        if len(body) != 1 or self.invalid:
            return
        if self.have_intent:
            self.invalid = True  # too many profiles
            return
        self.set_srgb(body[0])

    def chrm(self, body: bytes) -> None:
        if len(body) != 32:
            return
        xy = struct.unpack(">8I", body)
        if any(v > 0x7FFFFFFF for v in xy) or self.invalid:
            return
        if self.from_chrm:
            self.invalid = True  # duplicate
            return
        self.from_chrm = True
        result = _png_check_xy(xy)
        if result == 2:
            raise ValueError("PNG cHRM: libpng's internal error checking chromaticities")
        if result == 1 or self.have_endpoints and not _endpoints_match(xy, self.endpoints, 100):
            self.invalid = True  # chromaticities libpng cannot invert, or inconsistent with sRGB's
            return
        self.have_endpoints, self.endpoints = True, xy

    def iccp(self, body: bytes) -> None:
        if len(body) < 14 or self.invalid:
            return
        if self.have_intent:
            self.invalid = True  # too many profiles
            return
        head = body[:81]
        if len(body) - len(head) < 11:
            return  # "too short": ignored, the colour space kept
        kl = 0
        while kl < 80 and kl < len(head) and head[kl] != 0:
            kl += 1
        if not 1 <= kl <= 79 or not (kl + 1 < len(head) and head[kl + 1] == 0):
            self.invalid = True  # bad keyword or compression method
            return
        profile = self._inflate_profile(body[kl + 2:])
        if profile is None:
            self.invalid = True
            return
        adler = zlib.adler32(profile)
        length, intent = struct.unpack(">I", profile[:4])[0], struct.unpack(">I", profile[64:68])[0]
        md5 = struct.unpack(">4I", profile[84:100])
        for p_adler, p_crc, p_length, p_md5, p_intent in _SRGB_PROFILES:  # png_compare_ICC_profile_with_sRGB
            if md5 == p_md5 and (length, intent) == (p_length, p_intent):
                if adler == p_adler and zlib.crc32(profile) == p_crc:
                    self.set_srgb(intent)
                break  # an edited known profile is not sRGB

    def _inflate_profile(self, stream: bytes) -> Optional[bytes]:
        """The profile of an iCCP chunk if libpng takes it (png_icc_check_length,
        png_icc_check_header, png_icc_check_tag_table), else None."""
        d = zlib.decompressobj()
        try:
            head = d.decompress(stream, 132)
        except zlib.error:
            return None
        if len(head) < 132:
            return None
        length = struct.unpack(">I", head[:4])[0]
        if length < 132:
            return None
        intent, sig, space, pcs, cls = (struct.unpack(">I", head[64:68])[0], head[36:40], head[16:20],
                                        head[20:24], head[12:16])
        tags = struct.unpack(">I", head[128:132])[0]
        if ((head[8] > 3 and length & 3) or intent >= 0xFFFF or sig != b"acsp" or cls in (b"abst", b"link")
                or pcs not in (b"XYZ ", b"Lab ") or space != (b"RGB " if self.color & 2 else b"GRAY")
                or tags > 357913930 or length < 132 + 12 * tags):
            return None
        try:
            table = d.decompress(d.unconsumed_tail, 12 * tags)
        except zlib.error:
            return None
        if len(table) < 12 * tags:
            return None
        for i in range(tags):
            start, size = struct.unpack(">II", table[12 * i + 4: 12 * i + 12])
            if start > length or size > length - start:
                return None
        try:
            body = d.decompress(d.unconsumed_tail, length - 132 - 12 * tags)
        except zlib.error:
            return None
        profile = head + table + body
        return profile if len(profile) == length else None


def _gamma_table(file_gamma: int) -> Optional[bytes]:
    """The 8-bit table png_image_finish_read maps samples through: the file
    gamma (45455, sRGB's, when the file sets none) to the sRGB screen's
    (png_init_read_transformations, png_build_8bit_table,
    png_gamma_8bit_correct); None where libpng corrects nothing."""
    gtest = _png_muldiv(file_gamma, PNG_GAMMA_sRGB, PNG_FP_1)
    if gtest is not None and not _png_gamma_significant(gtest):
        return None
    r = math.floor(1e15 / file_gamma / PNG_GAMMA_sRGB + .5)  # png_reciprocal2
    g = int(r) if r <= 2147483647 else 0
    if not _png_gamma_significant(g):
        return None
    return bytes([0] + [math.floor(255 * math.pow(i / 255., g * .00001) + .5) for i in range(1, 255)] + [255])


class _Png:
    """A PNG's header, palette, inflated image data and the colour handling
    libpng gives it."""

    def __init__(self, data: bytes, what: str):
        _check_png(data, what)
        pos, idat, header, plte = 8, [], None, None
        space = None
        while pos + 8 <= len(data):
            length, kind = struct.unpack(">I4s", data[pos: pos + 8])
            body = data[pos + 8: pos + 8 + length]
            crc_at = pos + 8 + length
            if idat and kind != b"IDAT":
                break  # libpng reads no chunk past the image data
            if len(body) != length or crc_at + 4 > len(data):
                raise ValueError(f"{what}: truncated PNG chunk {kind!r}")
            critical = not kind[0] & 0x20
            if struct.unpack(">I", data[crc_at: crc_at + 4])[0] != zlib.crc32(kind + body):
                if critical:
                    raise ValueError(f"{what}: PNG chunk {kind!r} fails its CRC")
                pos = crc_at + 4  # an ancillary chunk with a bad CRC is dropped, as libpng drops it
                continue
            if kind == b"IHDR":
                if header is not None or length != 13:
                    raise ValueError(f"{what}: bad PNG IHDR")
                header = struct.unpack(">IIBBBBB", body)
                space = _Colorspace(header[3])
            elif header is None:
                raise ValueError(f"{what}: PNG without IHDR first")
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"PLTE":
                plte = self._plte(body, header, plte, what)
            elif kind in (b"gAMA", b"sRGB", b"iCCP", b"cHRM"):
                if plte is None:  # after PLTE (or IDAT) libpng drops them as out of place
                    getattr(space, kind.decode().lower())(body)
            elif kind == b"tRNS":
                pass  # the alpha it gives is dropped, as IMREAD_COLOR and the JAX reader drop it
            elif kind == b"IEND":
                break
            elif critical:
                raise ValueError(f"{what}: unknown critical PNG chunk {kind!r}")
            pos = crc_at + 4
        if header is None or not idat:
            raise ValueError(f"{what}: PNG without IHDR or IDAT")
        self.width, self.height, self.depth, self.color, compression, filtering, self.interlace = header
        if (self.color not in _PNG_DEPTHS or self.depth not in _PNG_DEPTHS[self.color] or compression or filtering
                or self.interlace > 1 or not 0 < self.width <= 1000000 or not 0 < self.height <= 1000000):
            raise ValueError(f"{what}: bad PNG header {header}")
        if self.color == 3 and plte is None:
            raise ValueError(f"{what}: PNG palette image without PLTE")
        try:
            self.raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
        except zlib.error as e:
            raise ValueError(f"{what}: PNG image data: {e}") from None
        self.gamma = None
        if self.depth <= 8:  # the JAX package decodes 16-bit PNGs with cv2, which corrects no gamma
            self.gamma = _gamma_table(space.gamma or PNG_GAMMA_sRGB_INVERSE)
        self.palette = None
        if plte is not None and self.color == 3:
            pal = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[: 1 << self.depth]
            pal[: len(entries)] = entries
            if self.gamma is not None:
                pal = np.frombuffer(self.gamma, np.uint8)[pal]
            self.palette = np.ascontiguousarray(pal)

    @staticmethod
    def _plte(body: bytes, header, plte, what: str) -> Optional[bytes]:
        """png_handle_PLTE: required for a palette image, a hint (ignored)
        in an RGB one, dropped in a gray one."""
        color = header[3]
        if plte is not None and color == 3:
            raise ValueError(f"{what}: PNG with a second PLTE")
        if not color & 2:
            return plte
        if len(body) > 768 or len(body) % 3:
            if color == 3:
                raise ValueError(f"{what}: bad PNG palette")
            return plte
        return body


def inflate_png(data: bytes, what: str = "image") -> Tuple[np.ndarray, int, int, int]:
    """(filtered scanlines as uint8, height, width, samples a pixel) of PNG
    bytes: the chunks walked with their CRCs checked, IDAT inflated."""
    png = _Png(data, what)
    return png.raw, png.height, png.width, _CHANNELS[png.color]


def decode_bgr(data: bytes, what: str = "image") -> np.ndarray:
    """(H, W, 3) uint8 BGR of PNG or JPEG bytes, as the JAX package's
    native.decode_bgr returns them."""
    return decode_resize_bgr(data, None, what)


def _decode_resize_jpeg(data: bytes, size: Optional[Tuple[int, int]], what: str) -> np.ndarray:
    try:
        h, w = jpeg_size(data)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    dh, dw = size if size is not None else (h, w)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((dh, dw, 3), np.uint8)
    msg = ctypes.create_string_buffer(256)
    rc = _library().jpeg_decode_resize_bgr(_ptr(buf), buf.size, h, w, _ptr(out), dh, dw, msg, len(msg))
    if rc == -2:
        raise NotImplementedError(f"{what}: {msg.value.decode()}")
    if rc != 0:
        raise ValueError(f"{what}: JPEG decode failed (code {rc}): {msg.value.decode()}")
    return out


def decode_resize_bgr(data: bytes, size: Optional[Tuple[int, int]], what: str = "image") -> np.ndarray:
    """PNG or JPEG bytes decoded to BGR and resized to `size` = (new_h,
    new_w) as PIL's BILINEAR does (None: not resized), in one C call."""
    orientation = cv2_orientation(data)
    if 2 <= orientation <= 8:  # turned as cv2.imread turns it, then resized
        img = orient(_decode_unturned(data, what), orientation)
        return img if size is None else resize_bilinear(img, *size)
    return _decode_unturned(data, what, size)


def _decode_unturned(data: bytes, what: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    if data[:3] == JPEG_SIGNATURE:
        return _decode_resize_jpeg(data, size, what)
    png = _Png(data, what)
    dh, dw = size if size is not None else (png.height, png.width)
    out = np.empty((dh, dw, 3), np.uint8)
    rc = _library().png_decode_resize_bgr(_ptr(png.raw), png.raw.size, png.height, png.width, png.depth, png.color,
                                           png.interlace, None if png.palette is None else _ptr(png.palette),
                                           png.gamma, _ptr(out), dh, dw)
    if rc != 0:
        raise ValueError(f"{what}: PNG decode failed (code {rc}: "
                         f"{'not enough image data' if rc == -1 else 'bad row filter'})")
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
    """Decode and resize encoded PNGs and JPEGs, each to its own (new_h,
    new_w) target (None skips it), through `executor` (a thread pool: zlib
    and the C calls release the GIL) or in turn. Counterpart of the JAX package's
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
