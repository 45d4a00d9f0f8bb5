"""The port's JPEG decoder (dd3d_tpu_torch/csrc/imageio.cpp, through
data/imageio.py) against the JAX package's native reader
(dd3d_tpu.data.native, libjpeg) and cv2.imdecode (libjpeg-turbo), byte for
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
- each kind the decoder does not read raises NotImplementedError naming it;
- the committed fixtures (tests/data/jpeg/) decode to their digests, which
  native and cv2 give;
- decode + resize at the nuScenes test size equals native's
  decode_resize_batch_multi, and a JSON-manifest nuScenes fixture with JPEG
  frames loads the JAX loader's test batches.
"""
import hashlib
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from dd3d_tpu.data import native
from dd3d_tpu_torch.data import imageio
from tests.data.jpeg.make_fixtures import FRAME, encode, scene, with_exif_orientation

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
    data = encode(grid_image(40, 64, "420"), 90, "444")
    if kind == "arithmetic":
        return with_frame_header(data, marker=0xC9)
    if kind == "arithmetic-dac":
        dac = (0xCC, b"\xff\xcc\x00\x04\x00\x10")
        segs = segments(data)
        return rebuild(segs[:1] + [dac] + segs[1:])
    if kind == "lossless":
        return with_frame_header(data, marker=0xC3)
    if kind == "hierarchical":
        return with_frame_header(data, marker=0xC5)
    if kind == "12-bit":
        return with_frame_header(data, precision=12)
    if kind == "cmyk":
        return with_frame_header(data, components=4)
    if kind == "2-component":
        return with_frame_header(data, components=2)
    if kind == "incomplete-progressive":  # the scans after the first two cut off
        prog = encode(grid_image(40, 64, "420"), 90, "420", progressive=True)
        sos = [i for i in range(len(prog) - 1) if prog[i] == 0xFF and prog[i + 1] == 0xDA]
        return prog[: sos[2]] + b"\xff\xd9"
    raise ValueError(kind)


@pytest.mark.parametrize("kind,match", [
    ("arithmetic", "arithmetic-coded"), ("arithmetic-dac", "arithmetic-coded"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12-bit", "12-bit"), ("cmyk", "CMYK"), ("2-component", "2-component"),
    ("incomplete-progressive", "progressive JPEG whose scans leave coefficient bits unsent"),
])
def test_unported_kinds_raise_naming_the_kind(kind, match):
    with pytest.raises(NotImplementedError, match=match):
        imageio.decode_bgr(unported(kind))


def test_committed_fixtures_decode_to_their_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".jpg"))
    assert names == sorted(digests) and len(names) >= 10
    agree = 0
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        want = digests[name]
        got = imageio.read_image_bgr(os.path.join(FIXTURES, name))
        assert list(got.shape) == want["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
        assert hashlib.sha256(native.decode_bgr(data).tobytes()).hexdigest() == want["sha256"], name
        agree += assert_equals_native(data, name)
        assert imageio.read_image_size(os.path.join(FIXTURES, name)) == tuple(want["shape"][:2]), name
    assert agree == len(names) - 2  # all but the EXIF file (cv2 rotates it) and the truncated one (cv2 refuses it)


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
