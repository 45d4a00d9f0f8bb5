"""The port's PNG reader (dd3d_tpu_torch/data/imageio.py, its C++ in
csrc/imageio.cpp) against what the JAX package's loader reads, byte for
byte (tests/reader_parity.py): its native reader, libpng 1.6's simplified
API, and cv2.imread where that refuses (16-bit files):

- gamma: libpng corrects 8-bit samples from the file's gAMA to sRGB when
  the two differ by more than its threshold; an sRGB chunk, or an iCCP that
  libpng takes for sRGB, sets the file gamma to sRGB's; a colour chunk that
  libpng finds inconsistent makes it drop the colour chunks after it. The
  grid: gAMA from 0.3 to 2.2 and either side of the threshold, alone, with
  sRGB, with a non-sRGB iCCP, with cHRM, in several orders and with invalid
  values, on every colour type, decode and decode + resize;
- palette images at 1, 2, 4 and 8 bits with and without tRNS, gray at 1, 2
  and 4 bits, Adam7 for every colour type and depth, 16-bit files (cv2's
  high byte, no gamma), at odd small sizes;
- the committed fixtures (tests/data/png/) decode to their digests, which
  the JAX reader gives.
"""
import hashlib
import json
import os
import struct

import numpy as np
import pytest

from dd3d_tpu.data import native
from dd3d_tpu_torch.data import imageio
from tests.data.png.make_fixtures import (chrm, chunk, encode_png, gama, icc_profile, iccp, palette_of,
                                          random_samples, srgb)
from tests.reader_parity import assert_reads_as_jax, jax_read

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "png")
COLORS = (0, 2, 3, 4, 6)
# file gammas of the grid: common ones, and either side of where libpng's
# gtest = gamma * 2.2 leaves [0.95, 1.05] (0.43182 and 0.47727)
GAMMAS = (0.3, 0.45, 0.45455, 0.476, 0.5, 0.55, 1.0, 2.2, 0.43181, 0.43183, 0.47726, 0.47728)
BAD_XY = (1, 2, 3, 4, 5, 6, 7, 8)  # chromaticities libpng cannot invert

pytestmark = pytest.mark.skipif(not native.available(), reason="the JAX package's native reader did not build")


def graw(value: int) -> bytes:
    return chunk(b"gAMA", struct.pack(">I", value))


def colour_chunks(kind: str, g: float, color: int) -> bytes:
    """The chunks before PLTE of one case of the gamma grid."""
    profile = icc_profile(b"RGB " if color & 2 else b"GRAY")
    ga = gama(g)
    return {"gama": ga, "gama+srgb": ga + srgb(), "srgb+gama": srgb() + ga, "gama+iccp": ga + iccp(profile),
            "iccp+gama": iccp(profile) + ga, "gama+chrm": ga + chrm(), "gama+bad-chrm+srgb": ga + chrm(BAD_XY) + srgb(),
            "gama+srgb+bad-chrm": ga + srgb() + chrm(BAD_XY), "gama+bad-iccp": ga + iccp(profile[:100]),
            "gama+iccp+srgb": ga + iccp(profile) + srgb(), "gama+gama": ga + graw(100000),
            "gama+bad-intent": ga + srgb(7)}[kind]


GRID_KINDS = ("gama", "gama+srgb", "srgb+gama", "gama+iccp", "iccp+gama", "gama+chrm", "gama+bad-chrm+srgb",
              "gama+srgb+bad-chrm", "gama+bad-iccp", "gama+iccp+srgb", "gama+gama", "gama+bad-intent")


@pytest.mark.parametrize("color", COLORS)
def test_gamma_grid_reads_as_libpng(color):
    rng = np.random.RandomState(color)
    corrected = 0
    for h, w in ((5, 4), (9, 13)):
        samples = random_samples(rng, h, w, color, 8)
        pal = palette_of(8) if color == 3 else None
        for kind in GRID_KINDS:
            for g in GAMMAS:
                data = encode_png(samples, 8, color, pal, None, 0, colour_chunks(kind, g, color))
                want = assert_reads_as_jax(data, f"{h}x{w} c{color} {kind} {g}", targets=((4, 7),) if h == 9 else ())
                plain = jax_read(encode_png(samples, 8, color, pal))
                corrected += want.tobytes() != plain.tobytes()
    assert corrected > 50  # the grid does reach libpng's correction


@pytest.mark.parametrize("g,max_diff", [(1.0, 72), (0.5, 9)])
def test_rgb_gamma_that_the_port_used_to_ignore(g, max_diff):
    """A 4x6 8-bit RGB PNG with gAMA 1.0 (or 0.5): libpng corrects its
    samples by up to 72 (9) levels, which the port returned raw before it
    read gAMA."""
    samples = np.arange(72).reshape(4, 6, 3) * 255 // 71
    want = assert_reads_as_jax(encode_png(samples, 8, 2, before=gama(g)), f"gAMA {g}", targets=((3, 5),))
    raw = samples[:, :, ::-1].astype(int)
    assert np.abs(want.astype(int) - raw).max() == max_diff


def test_gamma_chunks_out_of_place_or_invalid():
    """gAMA after PLTE is out of place (dropped); gAMA of 0, past 625000000
    or past 2^31, and an sRGB or iCCP chunk of a bad length, leave the
    default (no correction) or what came before."""
    rng = np.random.RandomState(3)
    for color in (2, 3):
        samples = random_samples(rng, 5, 4, color, 8)
        pal = palette_of(8) if color == 3 else None
        cases = [graw(0), graw(625000001), graw(0x80000000), graw(15), graw(16),
                 gama(1.0) + chunk(b"sRGB", b"\x00\x00"), gama(1.0) + chunk(b"iCCP", b"x\x00\x00"),
                 chunk(b"gAMA", b"\x00\x01\x86")]
        for i, before in enumerate(cases):
            assert_reads_as_jax(encode_png(samples, 8, color, pal, None, 0, before), f"c{color} case {i}")
        if color == 3:
            assert_reads_as_jax(encode_png(samples, 8, 3, pal, after_plte=gama(1.0)), "gAMA after PLTE")


@pytest.mark.parametrize("color,depths", [(0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                                          (6, (8, 16))])
def test_kinds_read_as_jax(color, depths):
    """Every depth of the colour type, non-interlaced and Adam7, with and
    without tRNS and gAMA, at odd small sizes; decode and decode + resize."""
    rng = np.random.RandomState(10 + color)
    trns = {0: struct.pack(">H", 1), 2: struct.pack(">HHH", 1, 2, 3), 3: bytes([0, 128, 255])}
    for depth in depths:
        pal = palette_of(depth) if color == 3 else None
        for h, w in ((5, 4), (7, 3), (1, 1), (9, 17)):
            for interlace in (0, 1):
                samples = random_samples(rng, h, w, color, depth)
                for t in (None, trns.get(color)):
                    for g in (None, 1.0):
                        data = encode_png(samples, depth, color, pal, t, interlace, gama(g) if g else b"")
                        assert_reads_as_jax(data, f"{h}x{w} c{color} {depth}-bit i{interlace} t{t} g{g}",
                                            targets=((3, 11),) if h == 9 else ())


def test_palette_index_past_the_palette_reads_black():
    """A 4-bit palette of 3 entries indexed up to 15: libpng's palette is
    256 zeroed entries, so the missing ones read black."""
    samples = np.arange(20).reshape(5, 4) % 16
    data = encode_png(samples, 4, 3, palette_of(2)[:3])
    want = assert_reads_as_jax(data, "short palette")
    assert (want[samples >= 3] == 0).all()


def test_chunks_libpng_reads_and_drops():
    """No IEND, anything after the image data, an ancillary chunk with a bad
    CRC: read as libpng reads them. An unknown critical chunk, a chunk
    between IDATs, a cut IDAT: refused by both."""
    rng = np.random.RandomState(4)
    data = encode_png(random_samples(rng, 6, 5, 2, 8), 8, 2, before=gama(1.0))
    iend = data.rindex(b"IEND") - 4
    idat = data.index(b"IDAT") - 4
    body = data[idat + 8: iend - 4]
    head = data[:idat]
    bad_crc = bytearray(data)
    bad_crc[data.index(b"gAMA") + 8] ^= 1  # inside gAMA's CRC'd bytes
    cases = {"no IEND": data[:iend], "after the data": data[:iend] + chunk(b"AbCD", b"x") + b"\x00\x00",
             "bad ancillary CRC": bytes(bad_crc), "unknown critical": head + chunk(b"AbCD", b"x") + data[idat:],
             "between IDATs": head + chunk(b"IDAT", body[:9]) + chunk(b"tEXt", b"a\x00b") + chunk(b"IDAT", body[9:]),
             "cut IDAT": data[: idat + 20]}
    decoded = {k: assert_reads_as_jax(v, k) is not None for k, v in cases.items()}
    assert decoded == {"no IEND": True, "after the data": True, "bad ancillary CRC": True, "unknown critical": False,
                       "between IDATs": False, "cut IDAT": False}


def test_committed_fixtures_decode_to_their_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".png"))
    assert names == sorted(digests) and len(names) >= 40
    for name in names:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        want = digests[name]
        got = imageio.read_image_bgr(path)
        assert list(got.shape) == want["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
        assert hashlib.sha256(jax_read(data, ".png").tobytes()).hexdigest() == want["sha256"], name
        assert imageio.read_image_size(path) == tuple(want["shape"][:2]), name


def test_kitti_loader_with_the_new_kinds_equals_jax(tmp_path):
    """A KITTI-format fixture whose 8 frames are the new kinds (gAMA,
    palette Adam7, 1-bit gray and 16-bit PNGs, the last with an EXIF
    orientation; arithmetic-coded, smoothed progressive, cut and CMYK JPEGs,
    the CMYK one turned by its EXIF orientation): both packages'
    TestDataLoader at dd3d_kitti_dla34's settings cut to 64 px give the same
    batches, byte for byte (the JAX loader decodes what its native reader
    refuses through its per-image fallback, cv2.imread then the resize)."""
    from dd3d_tpu.configs import get_experiment_cfg as jax_cfg
    from dd3d_tpu.data import register_datasets as jax_register
    from dd3d_tpu.data.build import TestDataLoader as JaxTestDataLoader
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.build import TestDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.overfit_smoke import make_fixture
    from tests.data.jpeg.make_fixtures import (NO_REFINEMENT, arithmetic, cmyk_pixels, cut_inside, encode,
                                               libjpeg_encode, scene, with_exif_orientation)

    rng = np.random.RandomState(7)
    h, w = 45, 70
    img = scene(rng, h, w)
    rgb = img[:, :, ::-1].astype(np.int64)
    exif6 = chunk(b"eXIf", b"MM\x00\x2a" + struct.pack(">IH", 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0)
                  + bytes(4))
    frames = [encode_png(rgb, 8, 2, before=gama(1.0)),
              encode_png(rgb[:, :, :1] * 0 + (rgb.sum(-1, keepdims=True) // 3 > 127), 1, 0),
              encode_png(random_samples(rng, h, w, 3, 8), 8, 3, palette_of(8), interlace=1),
              encode_png(rgb * 257, 16, 2, before=exif6),
              arithmetic(img, "420", progressive=1),
              libjpeg_encode(img, scans=NO_REFINEMENT, sampling="2x2,1x1,1x1"),
              cut_inside(encode(img, 90, "420", progressive=True), 0xC4, nth=3, at=.9),
              with_exif_orientation(libjpeg_encode(cmyk_pixels(img), colorspace="ycck"), 6)]
    root = make_fixture(str(tmp_path), n_images=len(frames))
    for i, data in enumerate(frames):
        with open(os.path.join(root, "KITTI3D", "training", "image_2", f"{i:06d}.png"), "wb") as f:
            f.write(data)
    batches = []
    for get_cfg, register, loader in ((jax_cfg, jax_register, JaxTestDataLoader),
                                      (get_experiment_cfg, register_datasets, TestDataLoader)):
        cfg = get_cfg("dd3d_kitti_dla34")
        cfg.DATASET_ROOT = root
        cfg.DATASETS.TEST.NAME = "kitti_3d_train"
        cfg.INPUT.RESIZE.MIN_SIZE_TEST = 64
        cfg.TEST.IMS_PER_BATCH = len(frames)
        register(cfg)
        batches.append(list(loader(cfg)))
    (got, want) = batches
    assert len(got) == len(want) == 1
    for (b, m), (jb, jm) in zip(got, want):
        assert list(b) == list(jb)
        for k, v in jb.items():
            assert b[k].dtype == v.dtype and b[k].shape == v.shape and b[k].tobytes() == v.tobytes(), k
