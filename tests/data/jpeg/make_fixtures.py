"""Write the JPEG fixtures of this directory with cv2 (libjpeg-turbo) and,
for what cv2 cannot write (arithmetic coding, CMYK and YCCK, scan scripts
that leave coefficient bits unsent), with write_jpeg.c, compiled here with
the system's cc against its jpeglib.h; and digests.json: the SHA-256 and
shape of each file's BGR decode by the JAX package's read_image_bgr (its
native reader, libjpeg; cv2.imread for the CMYK files that reader refuses).
A machine without cv2 or libjpeg cannot encode JPEGs, so the GPU checks
(chip_smoke.py phases 42 and 44, tests/test_torch_cuda.py) decode these
files with the port's reader and hold them to the digests;
tests/test_torch_jpeg.py holds the digests to native and cv2. From the repo
root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/data/jpeg/make_fixtures.py
"""
import hashlib
import json
import os
import struct
import subprocess
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLINGS = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
FRAME = "frame_900x1600.jpg"  # a nuScenes camera's size, 4:2:0 at quality 90
KITTI_HW = (375, 1242)  # the frames of chip_smoke.py phase 44
# libjpeg's sampling factors of the grid (Y, then Cb and Cr at 1x1)
LIBJPEG_SAMPLINGS = {"411": "4x1", "420": "2x2", "422": "2x1", "440": "1x2", "444": "1x1"}
# jpeg_simple_progression's script for YCbCr without its refinement scans,
# and one that refines the AC bits but leaves the DC's last bit unsent
NO_REFINEMENT = "0,1,2:0:0:0:1;0:1:5:0:2;2:1:63:0:1;1:1:63:0:1;0:6:63:0:2"
DC_UNREFINED = "0,1,2:0:0:0:1;0:1:63:0:1;1:1:63:0:0;2:1:63:0:0;0:1:63:1:0"
DC_ONLY = "0,1,2:0:0:0:2"


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


def writer() -> str:
    """write_jpeg.c compiled with the system's cc (once a source version, in
    the temporary directory)."""
    src = os.path.join(HERE, "write_jpeg.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    exe = os.path.join(tempfile.gettempdir(), f"write_jpeg_{tag}")
    if not os.path.exists(exe):
        tmp = f"{exe}.{os.getpid()}"
        subprocess.run(["cc", "-O2", "-o", tmp, src, "-ljpeg"], check=True)
        os.replace(tmp, exe)
    return exe


def libjpeg_encode(pixels: np.ndarray, space: str = None, **options) -> bytes:
    """`pixels` (H, W, C: gray, BGR, 2 components or CMYK) written by
    libjpeg's compressor with write_jpeg.c's key=value options."""
    h, w = pixels.shape[:2]
    c = 1 if pixels.ndim == 2 else pixels.shape[2]
    space = space or {1: "gray", 2: "unknown", 3: "rgb", 4: "cmyk"}[c]
    raw = pixels[:, :, ::-1] if c == 3 else pixels
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.raw"), os.path.join(d, "out.jpg")
        np.ascontiguousarray(raw, np.uint8).tofile(src)
        subprocess.run([writer(), src, dst, str(w), str(h), str(c), space]
                       + [f"{k}={v}" for k, v in options.items()], check=True)
        with open(dst, "rb") as f:
            return f.read()


def arithmetic(img: np.ndarray, sampling: str = "420", **options) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with progressive=1)."""
    if img.ndim == 3:
        options["sampling"] = f"{LIBJPEG_SAMPLINGS[sampling]},1x1,1x1"
    return libjpeg_encode(img, arith=1, **options)


def cmyk_pixels(img: np.ndarray) -> np.ndarray:
    """CMYK samples of a BGR image: inverted colour, K from the luma."""
    k = 255 - (img.astype(np.int64) @ np.array([29, 150, 77]) >> 8) // 2
    return np.concatenate([255 - img[:, :, ::-1], k[:, :, None]], -1).astype(np.uint8)


def cut_inside(data: bytes, marker: int, nth: int = 0, at: float = .5) -> bytes:
    """`data` cut `at` of the way into its nth marker segment of that kind."""
    starts = [i for i in range(2, len(data) - 3) if data[i] == 0xFF and data[i + 1] == marker]
    start = starts[nth]
    length = struct.unpack(">H", data[start + 2: start + 4])[0]
    return data[: start + 2 + int(length * at)]


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


def new_fixtures():
    """{file name: JPEG bytes}: the kinds the port reads since its
    arithmetic decoder, block smoothing and CMYK path, at odd small sizes,
    and chip_smoke.py phase 44's 375x1242 frames."""
    rng = np.random.RandomState(1)
    img = scene(rng, 37, 53)
    out = {f"arith_{s}.jpg": arithmetic(img, s) for s in LIBJPEG_SAMPLINGS}
    out["arith_gray.jpg"] = arithmetic(img[:, :, 1].copy())
    out["arith_5x4.jpg"] = arithmetic(scene(rng, 5, 4), "420")
    out["arith_progressive.jpg"] = arithmetic(img, "420", progressive=1)
    out["arith_progressive_7x3.jpg"] = arithmetic(scene(rng, 7, 3), "422", progressive=1, restart=1)
    out["arith_restart_2.jpg"] = arithmetic(img, "411", restart=2)
    out["arith_dac.jpg"] = arithmetic(img, "420", dc_l=1, dc_u=3, ac_k=10)
    cmyk = cmyk_pixels(img)
    out["cmyk_adobe.jpg"] = libjpeg_encode(cmyk)
    out["cmyk_no_adobe.jpg"] = libjpeg_encode(cmyk, adobe=0)
    out["ycck_adobe.jpg"] = libjpeg_encode(cmyk, colorspace="ycck")
    out["ycck_progressive_5x4.jpg"] = libjpeg_encode(cmyk_pixels(scene(rng, 5, 4)), colorspace="ycck", progressive=1)
    out["smooth_no_refinement.jpg"] = libjpeg_encode(img, scans=NO_REFINEMENT, sampling="2x2,1x1,1x1")
    out["smooth_dc_unrefined.jpg"] = libjpeg_encode(img, scans=DC_UNREFINED)
    out["smooth_dc_only_7x3.jpg"] = libjpeg_encode(scene(rng, 7, 3), scans=DC_ONLY, sampling="2x1,1x1,1x1")
    out["smooth_arith.jpg"] = libjpeg_encode(img, arith=1, scans=NO_REFINEMENT, sampling="2x2,1x1,1x1")
    prog = encode(img, 90, "420", progressive=True)
    out["progressive_cut_dht.jpg"] = cut_inside(prog, 0xC4, nth=3, at=.9)
    frame = scene(rng, *KITTI_HW)
    out["frame_arith.jpg"] = arithmetic(frame, "420", quality=90)
    out["frame_smoothed.jpg"] = libjpeg_encode(frame, scans=NO_REFINEMENT, sampling="2x2,1x1,1x1")
    out["frame_cut_mid_segment.jpg"] = cut_inside(encode(frame, 90, "420", progressive=True), 0xC4, nth=3)
    out["frame_cmyk.jpg"] = libjpeg_encode(cmyk_pixels(frame), colorspace="ycck")
    return out


def main():
    from tests.reader_parity import jax_read

    digests = {}
    for name, data in sorted({**fixtures(), **new_fixtures()}.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        bgr = jax_read(data, os.path.splitext(name)[1])
        assert bgr is not None, name
        digests[name] = {"sha256": hashlib.sha256(bgr.tobytes()).hexdigest(), "shape": list(bgr.shape)}
        print(f"{name}: {len(data)} bytes, {bgr.shape}")
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        f.write("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}" for k, v in sorted(digests.items()))
                + "\n}\n")


if __name__ == "__main__":
    main()
