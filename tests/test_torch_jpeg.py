"""The port's JPEG decoder (dd3d_tpu_torch/csrc/imageio.cpp, through
data/imageio.py) against the JAX package's native reader
(dd3d_tpu.data.native, libjpeg-turbo 2.1.5), its read_image_bgr (cv2.imread,
libjpeg-turbo 3.1.2, where native refuses) and cv2.imdecode, byte for
byte:

- the grid cv2 encodes here: sampling 4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4 and
  gray; quality 50, 90, 100; restart interval 0 and 3; baseline,
  progressive and optimized Huffman; sizes 1x1 to 900x1600 (5x4: chroma
  two samples wide, where libjpeg upsamples by replication, not fancy). The port equals
  native everywhere, and cv2 wherever cv2 equals native; `image_size`
  equals native.image_dims;
- a truncated file (native decodes it, its missing blocks mid-gray; cv2
  refuses it), an EXIF orientation (native ignores it; cv2 rotates), an
  RGB-coded file (Adobe transform 0), a file without DHT (the standard
  tables);
- files cut inside every marker segment and at points of the entropy-coded
  data of each committed fixture: native's bytes where native decodes
  (marker segments read on into jpeg_mem_src's fake EOI bytes, missing
  coefficient bits smoothed), a refusal where native and cv2 refuse;
- arithmetic coding, sequential and progressive, with restart intervals and
  DAC conditioning, over the sampling grid; CMYK and YCCK with and without
  the Adobe marker (cv2.imread's decode); block smoothing of progressive
  files whose scans leave coefficient bits unsent, as 2.1.5 smooths
  (cv2's 3.1.2 differs by up to 2), and of CMYK/YCCK ones as cv2's 3.1.2
  smooths them;
- arithmetic-coded files cut anywhere and files with corrupt scans, whose
  dequantized coefficients pass 16 bits (the IDCT in libjpeg-turbo's SIMD
  form);
- each kind the decoder does not read raises NotImplementedError naming it,
  and the list of such kinds is the one the decoder documents;
- the committed fixtures (tests/data/jpeg/) decode to their digests, which
  the JAX reader gives;
- decode + resize at the nuScenes test size equals native's
  decode_resize_batch_multi, and a JSON-manifest nuScenes fixture with JPEG
  frames loads the JAX loader's test batches.
"""
import hashlib
import io
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from dd3d_tpu.data import native
from dd3d_tpu_torch.data import imageio
from tests.data.jpeg.make_fixtures import (DC_ONLY, DC_UNREFINED, FRAME, NO_REFINEMENT, arithmetic, cmyk_pixels,
                                           encode, libjpeg_encode, scene, with_exif_orientation)
from tests.reader_parity import assert_reads_as_jax, jax_read

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
GRID_SIZES = [(1, 1), (3, 5), (5, 4), (17, 33), (375, 1242), (900, 1600)]
KINDS = ["411", "420", "422", "440", "444", "gray"]

pytestmark = pytest.mark.skipif(not native.available(), reason="the JAX package's native reader did not build")


def grid_image(h: int, w: int, kind: str) -> np.ndarray:
    img = scene(np.random.RandomState(h * 7 + w), h, w)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if kind == "gray" else img


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def assert_equals_native(data: bytes, what: str):
    """The port's decode equals native's, and cv2's wherever cv2's equals
    native's; returns whether cv2 agreed."""
    want = native.decode_bgr(data)
    assert want is not None, what
    got = imageio.decode_bgr(data, what)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), what
    ref = cv2_decode(data)
    return ref is not None and ref.shape == want.shape and ref.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", GRID_SIZES, ids=[f"{h}x{w}" for h, w in GRID_SIZES])
def test_decode_equals_libjpeg(size, kind):
    h, w = size
    img = grid_image(h, w, kind)
    cases = agree = 0
    for quality in (50, 90, 100):
        for rst in (0, 3):
            for mode in ({}, {"progressive": True}, {"optimize": True}):
                data = encode(img, quality, kind if kind != "gray" else "444", rst_interval=rst, **mode)
                what = f"{h}x{w} {kind} q{quality} rst{rst} {mode}"
                agree += assert_equals_native(data, what)
                cases += 1
                assert imageio.image_size(data) == native.image_dims(data) == (h, w), what
    assert agree == cases  # cv2 equals native on the whole grid


@pytest.mark.parametrize("sampling,rst", [("420", 0), ("422", 3), ("444", 2)])
def test_truncated_file_decodes_as_native(sampling, rst):
    data = encode(grid_image(120, 200, "420"), 90, sampling, rst_interval=rst)
    for frac in (0.2, 0.5, 0.8, 0.97):
        cut = data[: int(len(data) * frac)]
        assert_equals_native(cut, f"{sampling} rst{rst} cut at {frac}")
    # the cut right after a 0xFF byte of the entropy data
    at_ff = data.rindex(b"\xff", 0, len(data) // 2) + 1
    assert_equals_native(data[:at_ff], "cut after 0xFF")
    gray = imageio.decode_bgr(data[: len(data) // 2])
    assert (gray[-8:] == 128).all()  # the blocks past the data: mid-gray


def test_exif_orientation_is_ignored():
    data = with_exif_orientation(encode(grid_image(40, 70, "420"), 90, "420"))
    assert not assert_equals_native(data, "EXIF orientation 6")
    assert imageio.decode_bgr(data).shape == (40, 70, 3)
    assert cv2_decode(data).shape == (70, 40, 3)  # cv2 applies the rotation; the JAX package's reader does not
    assert imageio.image_size(data) == native.image_dims(data) == (40, 70)


def segments(data: bytes):
    """[(marker, bytes of the segment)] of a JPEG up to its first SOS, then
    (0xDA, the rest)."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            return out + [(marker, data[pos:])]
        length = struct.unpack(">H", data[pos + 2: pos + 4])[0]
        out.append((marker, data[pos: pos + 2 + length]))
        pos += 2 + length


def rebuild(segs) -> bytes:
    return b"\xff\xd8" + b"".join(s for _, s in segs)


def adobe_segment(transform: int) -> tuple:
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return 0xEE, b"\xff\xee" + struct.pack(">H", len(body) + 2) + body


def variant(name: str) -> bytes:
    img = grid_image(57, 91, "444")
    segs = segments(encode(img, 90, "444" if name.startswith("adobe") else "420"))
    if name == "no-dht":  # Motion-JPEG style: libjpeg-turbo installs the standard tables
        return rebuild([s for s in segs if s[0] != 0xC4])
    transform = int(name[-1])  # adobe0: RGB-coded, adobe1: YCbCr, adobe2: unknown, read as YCbCr
    return rebuild([adobe_segment(transform)] + [s for s in segs if s[0] != 0xE0])


@pytest.mark.parametrize("name", ["no-dht", "adobe0", "adobe1", "adobe2"])
def test_marker_variants_decode_as_native(name):
    assert_equals_native(variant(name), name)


def with_frame_header(data: bytes, marker: int = None, precision: int = None, components: int = None) -> bytes:
    segs = segments(data)
    out = []
    for m, s in segs:
        if m == 0xC0:
            m = marker or m
            body = bytearray(s[4:])
            if precision is not None:
                body[0] = precision
            if components is not None:
                comps = bytes(body[6:9]) + bytes(body[9:]) + bytes([4, 0x11, 1])
                body = body[:5] + bytes([components]) + comps[: 3 * components]
            s = bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + bytes(body)
        out.append((m, s))
    return rebuild(out)


def unported(kind: str) -> bytes:
    """A file of each kind the decoder refused before it read arithmetic
    coding, CMYK and smoothing; of the kinds it still refuses."""
    data = encode(grid_image(40, 64, "420"), 90, "444")
    if kind == "arithmetic":
        return arithmetic(grid_image(40, 64, "420"), "444")
    if kind == "arithmetic-dac":
        return arithmetic(grid_image(40, 64, "420"), "420", dc_l=2, dc_u=5, ac_k=3)
    if kind == "lossless":
        return with_frame_header(data, marker=0xC3)
    if kind == "hierarchical":
        return with_frame_header(data, marker=0xC5)
    if kind == "12-bit":
        return with_frame_header(data, precision=12)
    if kind == "cmyk":
        return libjpeg_encode(cmyk_pixels(grid_image(40, 64, "420")), colorspace="ycck")
    if kind == "2-component":
        return libjpeg_encode(grid_image(40, 64, "420")[:, :, :2].copy())
    if kind == "incomplete-progressive":  # the scans after the first two cut off
        prog = encode(grid_image(40, 64, "420"), 90, "420", progressive=True)
        sos = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
        return prog[: sos[2]] + b"\xff\xd9"
    raise ValueError(kind)


# the kinds this test refused before the port read them: now held to the JAX reader
PORTED = ("arithmetic", "arithmetic-dac", "cmyk", "incomplete-progressive")


@pytest.mark.parametrize("kind,match", [
    ("arithmetic", "arithmetic-coded"), ("arithmetic-dac", "arithmetic-coded"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12-bit", "12-bit"), ("cmyk", "CMYK"), ("2-component", "2-component"),
    ("incomplete-progressive", "progressive JPEG whose scans leave coefficient bits unsent"),
])
def test_unported_kinds_raise_naming_the_kind(kind, match):
    """Each kind the decoder does not read raises NotImplementedError naming
    it; the kinds it has come to read (PORTED) decode as the JAX reader
    decodes them. A 2-component file is refused by both JAX sides, and by
    the port."""
    data = unported(kind)
    if kind in PORTED:
        assert assert_reads_as_jax(data, kind, targets=((20, 32),)) is not None, kind
        return
    with pytest.raises(NotImplementedError, match=match):
        imageio.decode_bgr(data)
    assert jax_read(data, ".jpg") is None or kind != "2-component"


def test_the_refused_kinds_are_the_documented_ones():
    """The reader's NotImplementedErrors: ROADMAP's "not ported by design"
    kinds (lossless, hierarchical, 12/16-bit, fractional sampling) and the
    2-component file both JAX sides refuse; every PNG kind is read."""
    import re

    src = open(os.path.join(os.path.dirname(imageio.__file__), "..", "csrc", "imageio.cpp")).read()
    refusals = sorted(re.findall(r'unsupported\(\s*(?:std::to_string\([^)]*\) \+ )?"([^"]+)', src))
    assert refusals == sorted([
        "-bit JPEG (the decoder reads 8-bit samples)",
        "-component JPEG (libjpeg converts no such colour space to BGR, ",
        "JPEG with fractional sampling ratios (libjpeg does not upsample them)", "hierarchical JPEG (SOF",
        "lossless JPEG (SOF"]), refusals
    py = open(imageio.__file__).read()
    assert py.count("NotImplementedError(") == 1  # the JPEG decoder's refusal code
    sof = bytearray(encode(grid_image(21, 30, "420"), 90, "444"))
    at = sof.index(b"\xff\xc0")
    sof[at + 11], sof[at + 14] = 0x31, 0x21  # Y 3x1, Cb 2x1: 3 is no multiple of 2
    with pytest.raises(NotImplementedError, match="fractional sampling"):
        imageio.decode_bgr(bytes(sof))
    assert jax_read(bytes(sof), ".jpg") is None


def cut_points(data: bytes):
    """Offsets that cut `data` before, at and inside each marker segment
    (DHT, DQT, SOS, DRI, SOF, APPn) and at points of each scan's data."""
    points, pos, n = set(), 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF, 0x01) or 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        if data[pos + 1] == 0xD9:
            break
        end = pos + 2 + struct.unpack(">H", data[pos + 2: pos + 4])[0]
        points.update(range(pos - 1, pos + 6))
        points.update((pos + (end - pos) // 2, end - 2, end - 1, end, end + 1))
        if data[pos + 1] == 0xDA:  # its entropy-coded data, to the next marker but RSTn
            q = end
            while q + 1 < n and not (data[q] == 0xFF and data[q + 1] != 0 and not 0xD0 <= data[q + 1] <= 0xD7):
                q += 1
            points.update(end + (q - end) * f // 8 for f in range(1, 8))
            end = q
        pos = end
    return sorted(p for p in points if 3 <= p < n)


TRUNCATION_FIXTURES = ("progressive.jpg", "restart_3.jpg", "sampling_411.jpg", "sampling_420.jpg", "sampling_422.jpg",
                       "sampling_440.jpg", "sampling_444.jpg", "gray.jpg", "exif_orientation_6.jpg")


@pytest.mark.parametrize("name", TRUNCATION_FIXTURES)
def test_cut_inside_marker_segments_reads_as_native(name):
    """Every cut point of the fixture: native's bytes where native decodes,
    a refusal where native and cv2 refuse (cv2 refuses every cut file)."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    decoded = 0
    for p in cut_points(data):
        cut = data[:p]
        if native.decode_bgr(cut) is not None:
            decoded += assert_equals_native(cut, f"{name} cut at {p}") is False
        else:
            assert cv2_decode(cut) is None, p
            with pytest.raises((ValueError, NotImplementedError)):
                imageio.decode_bgr(cut)
    assert decoded >= 10


def test_pil_progressive_cut_at_60_percent():
    """A 33x47 progressive q90 file written by PIL, cut at 60 % of its bytes
    (inside a marker segment between scans): native decodes it, smoothing
    the missing bits; cv2 refuses it. The port raised 'truncated JPEG marker
    segment' before it read on into the fake EOI bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(scene(np.random.RandomState(0), 33, 47)[:, :, ::-1]).save(buf, "JPEG", quality=90,
                                                                             progressive=True)
    data = buf.getvalue()
    assert not assert_equals_native(data[: int(len(data) * .6)], "PIL progressive cut at 60 %")
    assert native.decode_bgr(data[: int(len(data) * .3)]) is None
    with pytest.raises(ValueError):
        imageio.decode_bgr(data[: int(len(data) * .3)])


@pytest.mark.parametrize("kind", KINDS)
def test_arithmetic_reads_as_native(kind):
    """SOF9 and SOF10 over the sampling grid: sequential, progressive,
    restart intervals, DAC conditioning, at odd small sizes; decode and
    decode + resize."""
    for h, w in ((1, 1), (5, 4), (7, 3), (37, 53)):
        img = grid_image(h, w, kind)
        sampling = "444" if kind == "gray" else kind
        for options in ({}, {"progressive": 1}, {"restart": 2}, {"progressive": 1, "restart": 1},
                        {"dc_l": 1, "dc_u": 3, "ac_k": 10}, {"quality": 100}):
            data = arithmetic(img, sampling, **options)
            assert assert_equals_native(data, f"{h}x{w} {kind} {options}")  # cv2 reads them alike
            if h == 37:
                assert_reads_as_jax(data, f"{kind} {options}", targets=((18, 26), (64, 90)))


@pytest.mark.parametrize("options", [{"progressive": 1}, {"restart": 2}, {"quality": 100}],
                         ids=["progressive", "restart", "q100"])
def test_cut_arithmetic_reads_as_native(options):
    """An arithmetic-coded file cut anywhere: past the end its decoder reads
    zero data, which decodes to garbage coefficients past 16 bits once
    dequantized; native's IDCT (libjpeg-turbo's SIMD form: 16-bit lanes that
    wrap and saturate) and the port's give the same bytes."""
    data = arithmetic(grid_image(61, 93, "420"), "420", **options)
    decoded = 0
    for p in cut_points(data) + list(range(200, len(data), 29)):
        if native.decode_bgr(data[:p]) is not None:
            decoded += assert_equals_native(data[:p], f"cut at {p}") is not None
    assert decoded >= 20


def test_corrupt_entropy_data_reads_as_native():
    """Bytes flipped at random in the scans of committed fixtures (Huffman
    and arithmetic, baseline, progressive, restart): wherever native
    decodes the file, the port gives its bytes."""
    rng = np.random.RandomState(0)
    decoded = 0
    for name in ("progressive.jpg", "restart_3.jpg", "arith_420.jpg", "arith_progressive.jpg"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        sos = data.index(b"\xff\xda")
        for _ in range(25):
            b = bytearray(data)
            for i in rng.randint(sos + 20, len(data) - 2, 3):
                b[i] = rng.randint(0, 256)
            if native.decode_bgr(bytes(b)) is not None:
                decoded += assert_equals_native(bytes(b), name) is not None
    assert decoded >= 40


@pytest.mark.parametrize("size", [(5, 4), (7, 3), (37, 53)], ids=["5x4", "7x3", "37x53"])
def test_cmyk_reads_as_cv2(size):
    """4-component files, which native refuses: cv2.imread's decode
    (libjpeg to CMYK, then cv2's own CMYK -> BGR), with and without the
    Adobe marker, YCCK or CMYK, baseline, progressive and arithmetic;
    decode and decode + resize."""
    cmyk = cmyk_pixels(grid_image(*size, "420"))
    for options in ({}, {"adobe": 0}, {"colorspace": "ycck"}, {"colorspace": "ycck", "adobe": 0},
                    {"progressive": 1}, {"colorspace": "ycck", "arith": 1, "restart": 1},
                    {"sampling": "2x2,1x1,1x1,2x2"}):
        data = libjpeg_encode(cmyk, **options)
        assert native.decode_bgr(data) is None
        assert assert_reads_as_jax(data, f"{size} {options}", targets=((3, 5), (40, 60))) is not None


SMOOTHING_SCRIPTS = {"dc only": DC_ONLY, "no refinement": NO_REFINEMENT, "dc unrefined": DC_UNREFINED,
                     "dc then ac 1-5": "0,1,2:0:0:0:0;0:1:5:0:2",
                     "per component": "0:0:0:0:1;1:0:0:0:0;2:0:0:0:3;0:1:2:0:1;0:3:63:0:0"}


@pytest.mark.parametrize("script", sorted(SMOOTHING_SCRIPTS))
def test_block_smoothing_reads_as_libjpeg_turbo_2_1_5(script):
    """Progressive scripts that leave coefficient bits unsent, over sampling
    factors and sizes (the 5x5 window's edges), Huffman and arithmetic:
    native's bytes."""
    for h, w in ((1, 1), (5, 4), (7, 3), (17, 33), (37, 53), (70, 9)):
        img = grid_image(h, w, "420")
        for sampling in ("2x2,1x1,1x1", "1x1,1x1,1x1", "2x1,1x2,1x1", "1x2,1x1,1x1", "4x1,1x1,1x1"):
            for arith in (0, 1):
                data = libjpeg_encode(img, scans=SMOOTHING_SCRIPTS[script], sampling=sampling, arith=arith)
                assert_equals_native(data, f"{h}x{w} {script} {sampling} arith={arith}")


def test_smoothing_follows_native_not_cv2():
    """The smoothed fixtures: native (libjpeg-turbo 2.1.5) smooths them as
    the port does; cv2's bundled 3.1.2 takes other blocks around a block
    near the image's edges and differs by 1 or 2."""
    for name in ("frame_smoothed.jpg", "smooth_no_refinement.jpg", "smooth_arith.jpg"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        assert not assert_equals_native(data, name)
        diff = np.abs(cv2_decode(data).astype(int) - native.decode_bgr(data))
        assert 1 <= diff.max() <= 2, name


@pytest.mark.parametrize("sampling", ["1x1,1x1,1x1,1x1", "2x1,1x1,1x1,1x1", "1x2,1x1,1x1,1x1", "2x2,1x1,1x1,2x2"])
def test_cmyk_smoothing_reads_as_cv2(sampling):
    """A CMYK/YCCK file whose scans leave coefficient bits unsent, complete
    or cut, is read by cv2.imread (native refuses 4 components), which
    smooths it as libjpeg-turbo 3.1.2 does: the port's 3.1.2 neighbourhood
    (whole-buffer rows, the last column repeated) gives cv2's bytes, over
    sizes either side of an iMCU row and a partial last one."""
    for h, w in ((1, 1), (9, 8), (17, 33), (24, 16), (40, 17), (25, 9)):
        cmyk = cmyk_pixels(grid_image(h, w, "420"))
        for script in (DC_ONLY.replace("0,1,2:", "0,1,2,3:"), "0,1,2,3:0:0:0:1;0:1:63:0:1;1:1:63:0:1;2:1:63:0:1"):
            for space in ("cmyk", "ycck"):
                data = libjpeg_encode(cmyk, colorspace=space, scans=script, sampling=sampling)
                assert native.decode_bgr(data) is None
                assert_reads_as_jax(data, f"{h}x{w} {space} {script}")
    data = libjpeg_encode(cmyk_pixels(grid_image(61, 93, "420")), colorspace="ycck", progressive=1, sampling=sampling)
    for p in cut_points(data)[::3]:
        assert_reads_as_jax(data[:p], f"cut at {p}")


def test_committed_fixtures_decode_to_their_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))
    assert names == sorted(digests) and len(names) >= 35
    cv2_differs = set()
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        want = digests[name]
        got = imageio.read_image_bgr(os.path.join(FIXTURES, name))
        assert list(got.shape) == want["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
        assert hashlib.sha256(jax_read(data, ".jpg").tobytes()).hexdigest() == want["sha256"], name
        assert imageio.read_image_size(os.path.join(FIXTURES, name)) == tuple(want["shape"][:2]), name
        ref = cv2_decode(data)
        if ref is None or ref.shape != got.shape or ref.tobytes() != got.tobytes():
            cv2_differs.add(name)
    # cv2.imdecode rotates the EXIF file, refuses the cut ones, and smooths by 3.1.2's rules
    assert cv2_differs == {"exif_orientation_6.jpg", "truncated.jpg", "progressive_cut_dht.jpg",
                           "frame_cut_mid_segment.jpg", "frame_smoothed.jpg", "smooth_no_refinement.jpg",
                           "smooth_arith.jpg"}


def test_image_size_reads_past_large_segments(tmp_path):
    """A JPEG whose frame header lies 70 KB in, past an APP segment and a
    comment: read_image_size reads on until it finds it."""
    data = encode(grid_image(33, 17, "420"), 90, "420")
    pad = b"\xff\xe2" + struct.pack(">H", 65000) + bytes(64998) + b"\xff\xfe\x10\x02" + bytes(4096)
    path = tmp_path / "late_sof.jpg"
    path.write_bytes(data[:2] + pad + data[2:])
    assert imageio.read_image_size(str(path)) == native.image_dims(path.read_bytes()) == (33, 17)
    with pytest.raises(imageio.TruncatedHeader):
        imageio.image_size(path.read_bytes()[:4096])
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        imageio.image_size(b"GIF89a" + bytes(30))


def test_decode_resize_equals_native_batch_at_the_nuscenes_test_size(tmp_path):
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.augmentations import resize_shortest_edge_dims

    cfg = get_experiment_cfg("dd3d_nusc_dla34")
    size, max_size = cfg.INPUT.RESIZE.MIN_SIZE_TEST, cfg.INPUT.RESIZE.MAX_SIZE_TEST
    blobs = [open(os.path.join(FIXTURES, n), "rb").read()
             for n in (FRAME, "sampling_411.jpg", "progressive.jpg", "gray.jpg", "truncated.jpg")]
    png = str(tmp_path / "frame.png")
    imageio.write_png(png, imageio.decode_bgr(blobs[0])[:450, :800])
    blobs.append(open(png, "rb").read())
    targets = [resize_shortest_edge_dims(*imageio.image_size(b), size, max_size) for b in blobs]
    targets[2] = None
    assert targets[0] == (896, 1593)
    want = native.decode_resize_batch_multi(blobs, targets)
    with ThreadPoolExecutor(4) as pool:
        got = imageio.decode_resize_batch(blobs, targets, pool)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None) == (targets[i] is None), i
        if w is not None:
            assert g.shape == w.shape and g.tobytes() == w.tobytes(), i


def test_nuscenes_json_loader_with_jpeg_frames_equals_jax(tmp_path):
    """make_nusc_fixture's manifest with every frame re-encoded as a JPEG
    (each camera at another sampling, one truncated), through both
    packages' TestDataLoader at dd3d_nusc_dla34's settings cut to 64 px."""
    from dd3d_tpu.configs import get_experiment_cfg as jax_cfg
    from dd3d_tpu.data import register_datasets as jax_register
    from dd3d_tpu.data.build import TestDataLoader as JaxTestDataLoader
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.build import TestDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE, make_nusc_fixture

    root = make_nusc_fixture(str(tmp_path), n_samples=2, height=90, width=160)
    ds_dir = os.path.join(root, "json_datasets")
    manifest_path = os.path.join(ds_dir, f"{NUSC_FIXTURE}.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["name"] = "nusc_jpeg_fixture"
    samplings = ["420", "411", "422", "440", "444", "420"]
    for i, d in enumerate(manifest["dicts"]):
        png = os.path.join(ds_dir, d["file_name"])
        data = encode(imageio.read_image_bgr(png), 85, samplings[i % 6], progressive=i % 4 == 1)
        if i == 5:
            data = data[: len(data) * 3 // 4]
        d["file_name"] = d["file_name"].replace(".png", ".jpg")
        with open(os.path.join(ds_dir, d["file_name"]), "wb") as f:
            f.write(data)
        os.remove(png)
    os.remove(manifest_path)
    with open(os.path.join(ds_dir, "nusc_jpeg_fixture.json"), "w") as f:
        json.dump(manifest, f)

    batches = []
    for get_cfg, register, loader in ((jax_cfg, jax_register, JaxTestDataLoader),
                                      (get_experiment_cfg, register_datasets, TestDataLoader)):
        cfg = get_cfg("dd3d_nusc_dla34")
        cfg.DATASET_ROOT = root
        cfg.DATASETS.TEST.NAME = "nusc_jpeg_fixture"
        cfg.INPUT.RESIZE.MIN_SIZE_TEST = 64
        cfg.TEST.IMS_PER_BATCH = 6
        register(cfg)
        batches.append(list(loader(cfg, group_size=6)))
    (got, want) = batches
    assert len(got) == len(want) == 2
    for (b, m), (jb, jm) in zip(got, want):
        assert list(b) == list(jb) and m == jm
        for k, v in jb.items():
            assert b[k].dtype == v.dtype and b[k].shape == v.shape and b[k].tobytes() == v.tobytes(), k
    assert got[0][0]["image"].shape[1:3] == (128, 128)
