"""PNG fixtures written by hand (PIL writes no Adam7 and few of these
kinds): palette images with and without tRNS at bit depths 1-8, gray at 1,
2 and 4 bits, Adam7 for every colour type and depth, 16-bit images of every
colour type, and gAMA, sRGB, iCCP and cHRM chunks. `encode_png` writes any
of them; `fixtures()` is the committed set (odd small sizes, and one
375x1242 frame a kind for chip_smoke.py phase 44), and digests.json holds
the SHA-256 and shape of each file's BGR decode by the JAX package's
`read_image_bgr`: its native reader (libpng's simplified API, with its gamma
handling) where that decodes the file, cv2.imread (the high byte of a
16-bit sample, no gamma) where it refuses. tests/test_torch_png.py holds the
port to both live and to the digests; the card's machine, which has
neither, holds its decodes to the digests. From the repo root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/data/png/make_fixtures.py
"""
import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
FRAME_HW = (375, 1242)  # a KITTI frame


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def gama(gamma: float) -> bytes:
    return chunk(b"gAMA", struct.pack(">I", int(round(gamma * 100000))))


def srgb(intent: int = 0) -> bytes:
    return chunk(b"sRGB", bytes([intent]))


def chrm(xy=(31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000)) -> bytes:
    return chunk(b"cHRM", struct.pack(">8I", *xy))


def icc_profile(space: bytes = b"RGB ", pcs: bytes = b"XYZ ", cls: bytes = b"mntr") -> bytes:
    """A small ICC profile that libpng's checks take (and that is no known
    sRGB profile): a 128-byte header, a tag table of one wtpt tag."""
    tag = b"XYZ " + bytes(4) + struct.pack(">3i", 63190, 65536, 54061)
    length = 128 + 4 + 12 + len(tag)
    header = bytearray(128)
    struct.pack_into(">I", header, 0, length)
    header[8:12] = bytes([2, 0x10, 0, 0])
    header[12:16], header[16:20], header[20:24], header[36:40] = cls, space, pcs, b"acsp"
    struct.pack_into(">3i", header, 68, 63190, 65536, 54061)  # the D50 illuminant
    return bytes(header) + struct.pack(">I", 1) + b"wtpt" + struct.pack(">II", 144, len(tag)) + tag


def iccp(profile: bytes, name: bytes = b"profile") -> bytes:
    return chunk(b"iCCP", name + b"\x00\x00" + zlib.compress(profile))


def pack_rows(samples: np.ndarray, depth: int) -> list:
    """Rows of (h, w, channels) integer samples as PNG packs them: 16-bit big
    endian, below 8 bits MSB first with each row padded to a byte."""
    h, w, c = samples.shape
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    per = 8 // depth
    rows = []
    for y in range(h):
        v = samples[y, :, 0].astype(np.int64)
        v = np.concatenate([v, np.zeros((-len(v)) % per, np.int64)]).reshape(-1, per)
        shifts = 8 - depth * (np.arange(per) + 1)
        rows.append((v << shifts).sum(1).astype(np.uint8).tobytes())
    return rows


def filter_rows(rows: list, bpp: int, filters) -> bytes:
    """The rows of one image or pass, each with its filter type (PNG
    specification, section 9; `filters` cycles over the rows)."""
    out, prev = [], None
    for y, row in enumerate(rows):
        a = np.frombuffer(row, np.uint8).astype(np.int64)
        up = np.zeros_like(a) if prev is None else prev
        left = np.concatenate([np.zeros(bpp, np.int64), a[:-bpp]])[: len(a)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])[: len(a)]
        f = filters[y % len(filters)]
        if f == 0:
            d = a
        elif f == 1:
            d = a - left
        elif f == 2:
            d = a - up
        elif f == 3:
            d = a - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            d = a - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([f]) + (d % 256).astype(np.uint8).tobytes())
        prev = a
    return b"".join(out)


def encode_png(samples: np.ndarray, depth: int, color: int, palette: np.ndarray = None, trns: bytes = None,
               interlace: int = 0, before: bytes = b"", after_plte: bytes = b"", filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of `samples` ((h, w, channels) integers, RGB order; palette
    indices for color 3), `before` (chunks) written after IHDR, then PLTE,
    `after_plte`, tRNS, IDAT (every filter type in turn; Adam7 when
    interlace is 1) and IEND."""
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    assert c == CHANNELS[color]
    bpp = max(1, depth * c // 8)
    if interlace:
        data = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                data += filter_rows(pack_rows(sub, depth), bpp, filters)
    else:
        data = filter_rows(pack_rows(samples, depth), bpp, filters)
    png = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)) + before
    if palette is not None:
        png += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    png += after_plte
    if trns is not None:
        png += chunk(b"tRNS", trns)
    return png + chunk(b"IDAT", zlib.compress(data, 9)) + chunk(b"IEND", b"")


def random_samples(rng: np.random.RandomState, h: int, w: int, color: int, depth: int) -> np.ndarray:
    return rng.randint(0, 1 << depth, (h, w, CHANNELS[color]))


def scene_samples(h: int, w: int, color: int, depth: int, seed: int = 0) -> np.ndarray:
    """make_fixtures.scene of tests/data/jpeg (a camera-like frame that
    compresses) in the samples of a colour type and depth; for a palette,
    indices into palette_of(depth)."""
    from tests.data.jpeg.make_fixtures import scene

    rgb = scene(np.random.RandomState(seed), h, w)[:, :, ::-1].astype(np.int64)
    gray = (rgb * [77, 150, 29]).sum(-1) >> 8
    if color == 3:
        pal = palette_of(depth).astype(np.int64)
        idx = np.argmin(((rgb[:, :, None, :] - pal[None, None]) ** 2).sum(-1), -1)
        return idx[:, :, None]
    full = {0: gray[..., None], 4: np.stack([gray, 255 - gray], -1), 2: rgb,
            6: np.concatenate([rgb, gray[..., None]], -1)}[color]
    return full * 257 if depth == 16 else full >> (8 - depth)


def palette_of(depth: int) -> np.ndarray:
    """A palette of 2^depth colours (at most 256) spread over the cube."""
    n = 1 << depth
    rng = np.random.RandomState(depth)
    return rng.randint(0, 256, (n, 3)).astype(np.uint8)


def fixtures():
    """{file name: PNG bytes}: each new kind at an odd small size, and the
    phase 44 frames at 375x1242."""
    out = {}
    rng = np.random.RandomState(0)
    for depth in (1, 2, 4, 8):
        for trns in (False, True):
            s = random_samples(rng, 7, 3, 3, depth)
            t = bytes(rng.randint(0, 256, min(1 << depth, 5)).astype(np.uint8)) if trns else None
            out[f"palette_{depth}bit{'_trns' if trns else ''}.png"] = encode_png(s, depth, 3, palette_of(depth), t)
    for depth in (1, 2, 4):
        out[f"gray_{depth}bit.png"] = encode_png(random_samples(rng, 5, 4, 0, depth), depth, 0)
        out[f"gray_{depth}bit_trns.png"] = encode_png(random_samples(rng, 5, 4, 0, depth), depth, 0,
                                                     trns=struct.pack(">H", 1))
    for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            out[f"adam7_c{color}_{depth}bit.png"] = encode_png(
                random_samples(rng, 7, 3 if depth < 8 else 5, color, depth), depth, color,
                palette_of(depth) if color == 3 else None, interlace=1)
    for color in (0, 2, 4, 6):
        out[f"16bit_c{color}.png"] = encode_png(random_samples(rng, 5, 4, color, 16), 16, color)
    out["16bit_c2_gama1.png"] = encode_png(random_samples(rng, 5, 4, 2, 16), 16, 2, before=gama(1.0))
    for g in (0.3, 0.5, 1.0, 2.2):
        for color in (0, 2, 4, 6):
            out[f"gama_{g}_c{color}.png"] = encode_png(random_samples(rng, 5, 4, color, 8), 8, color, before=gama(g))
    out["gama_1.0_palette_trns.png"] = encode_png(random_samples(rng, 7, 3, 3, 8), 8, 3, palette_of(8),
                                                  bytes(range(0, 250, 10)), before=gama(1.0))
    out["gama_1.0_srgb.png"] = encode_png(random_samples(rng, 5, 4, 2, 8), 8, 2, before=gama(1.0) + srgb())
    out["gama_1.0_iccp.png"] = encode_png(random_samples(rng, 5, 4, 2, 8), 8, 2, before=gama(1.0) + iccp(icc_profile()))
    h, w = FRAME_HW
    out["frame_gama.png"] = encode_png(scene_samples(h, w, 2, 8), 8, 2, before=gama(1.0))
    out["frame_palette_adam7.png"] = encode_png(scene_samples(h, w, 3, 8), 8, 3, palette_of(8), interlace=1)
    out["frame_adam7.png"] = encode_png(scene_samples(h, w, 2, 8), 8, 2, interlace=1)
    out["frame_16bit.png"] = encode_png(scene_samples(h, w, 2, 16), 16, 2)
    return out


def main():
    from tests.reader_parity import jax_read

    digests = {}
    for name, data in sorted(fixtures().items()):
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
