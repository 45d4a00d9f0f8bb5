"""The port's visualizers (dd3d_tpu_torch/visualizers/) against the JAX
package's (dd3d_tpu/visualizers/), which draw with cv2 (5.0 here): every
primitive, the dataloader and prediction visualizers, `mosaic` and
`save_vis`, compared at tolerance 0, every pixel. Cases are drawn by
hypothesis from fixed seeds (derandomized), over canvases of a few sizes.

The text glyphs of the port are a table recovered from cv2's own rendering
(`recover_glyph_table`): `python -m tests.test_torch_visualizers` rewrites
dd3d_tpu_torch/visualizers/font_simplex.py from it, and
`test_glyph_table_is_cv2s` holds the stored table to a fresh recovery.
"""
import base64
import os
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dd3d_tpu.visualizers import draw as jdraw
from dd3d_tpu_torch.visualizers import draw as pdraw
from dd3d_tpu_torch.visualizers import raster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT_MODULE = os.path.join(REPO, "dd3d_tpu_torch", "visualizers", "font_simplex.py")
PRINTABLE = "".join(chr(c) for c in range(32, 127))
CASES = settings(max_examples=60, derandomize=True, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])

# ---------------------------------------------------------------- the glyphs


def _render(text, org, shape):
    img = np.zeros(shape, np.uint8)
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 255, 1)
    return img


def _blend(dst, cov):
    """cv2 5.0's glyph blend of white over `dst` (the rule raster.put_text
    applies per channel)."""
    a = cov.astype(np.int64)
    return ((dst.astype(np.int64) * (255 - a) + 255 * a + 127) // 255).astype(np.uint8)


def recover_glyph_table():
    """[(code, advance, x offset, y offset, coverage)] for printable ASCII,
    from cv2.putText(FONT_HERSHEY_SIMPLEX, 0.5, thickness 1): each glyph
    rendered alone, white on black, is its coverage (the blend of 255 over 0
    at coverage a is a); its offsets are those of its bounding box from the
    text origin; its advance is the one shift of '|' at which the glyph and
    '|' blended in turn give cv2's rendering of the pair."""
    org, shape = (40, 40), (80, 120)
    bar = _render("|", org, shape)
    table = []
    for code in range(32, 127):
        ch = chr(code)
        g = _render(ch, org, shape)
        pair = _render(ch + "|", org, shape)
        advances = [k for k in range(40) if np.array_equal(
            _blend(g, np.pad(bar, ((0, 0), (k, 0)))[:, :shape[1]]), pair)]
        assert advances, f"no advance reproduces {ch!r}|"
        ys, xs = np.nonzero(g)
        if len(ys) == 0:
            table.append((code, advances[0], 0, 0, np.zeros((0, 0), np.uint8)))
            continue
        cov = g[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        table.append((code, advances[0], int(xs.min() - org[0]), int(ys.min() - org[1]), cov))
    return table


def write_font_module(path=FONT_MODULE):
    table = recover_glyph_table()
    metrics = ",\n    ".join(f"({c}, {a}, {ox}, {oy}, {cov.shape[0]}, {cov.shape[1]})" for c, a, ox, oy, cov in table)
    blob = base64.b64encode(zlib.compress(b"".join(cov.tobytes() for *_, cov in table), 9)).decode()
    lines = [blob[i:i + 100] for i in range(0, len(blob), 100)]
    data = "\n".join(f'    "{ln}"' for ln in lines)
    with open(path, "w") as f:
        f.write(f'''"""Glyphs of cv2.putText(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1) as
OpenCV 5.0 renders them: per printable ASCII character its pen advance, the
offset of its bounding box from the text origin (baseline left), and its
anti-aliased coverage bitmap (0-255), recovered from cv2's own rendering of
each glyph white on black. Written by `python -m tests.test_torch_visualizers`
(the test holds it to a fresh recovery); used by visualizers/raster.put_text.
"""
import base64
import functools
import zlib

import numpy as np

# (character code, advance, x offset, y offset, height, width); the coverage
# bytes of all glyphs, row-major, follow one another in _DATA in this order.
_METRICS = (
    {metrics},
)
_DATA = (
{data}
)


@functools.lru_cache(maxsize=None)
def glyphs():
    """{{character: (advance, x offset, y offset, (h, w) uint8 coverage)}}."""
    raw = np.frombuffer(zlib.decompress(base64.b64decode("".join(_DATA))), np.uint8)
    out, at = {{}}, 0
    for code, adv, ox, oy, h, w in _METRICS:
        out[chr(code)] = (adv, ox, oy, raw[at:at + h * w].reshape(h, w))
        at += h * w
    assert at == raw.size
    return out
''')


# ---------------------------------------------------------------- the tests


def test_glyph_table_is_cv2s():
    """The stored table is what cv2 renders here, glyph for glyph."""
    from dd3d_tpu_torch.visualizers.font_simplex import glyphs

    stored = glyphs()
    recovered = recover_glyph_table()
    assert sorted(stored) == [chr(c) for c, *_ in recovered]
    for code, adv, ox, oy, cov in recovered:
        s_adv, s_ox, s_oy, s_cov = stored[chr(code)]
        assert (s_adv, s_ox, s_oy) == (adv, ox, oy), chr(code)
        np.testing.assert_array_equal(s_cov, cov, err_msg=chr(code))


def _canvas(rng, h, w):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("start", range(0, 95, 19))
def test_every_printable_glyph(start):
    """Each printable ASCII glyph alone and in a run, at scale 0.5 (the
    drawing code's), in every palette color on a noisy canvas, inside, at
    and across the borders."""
    rng = np.random.RandomState(start)
    chars = PRINTABLE[start:start + 19]
    for i, ch in enumerate(chars):
        color = jdraw.DEFAULT_COLORS[i % len(jdraw.DEFAULT_COLORS)]
        for text, org in ((ch, (9, 20)), (ch * 3 + chars, (-4, 11)), (chars[::-1] + ch, (40, 3)), (ch, (59, 33))):
            img = _canvas(rng, 36, 60)
            want = cv2.putText(img.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
            got = raster.put_text(img.copy(), text, org, color)
            np.testing.assert_array_equal(got, want, err_msg=f"{text!r} at {org}")


def _coord(limit):
    """A coordinate inside, near or well outside [0, limit)."""
    return st.one_of(st.integers(-4, limit + 4), st.integers(-3 * limit, 4 * limit))


@st.composite
def boxes2d_case(draw):
    h, w = draw(st.sampled_from([(48, 64), (75, 110), (120, 96)]))
    n = draw(st.integers(0, 7))
    boxes = []
    for _ in range(n):
        x1, y1 = draw(_coord(w)), draw(_coord(h))
        kind = draw(st.sampled_from(["any", "degenerate", "negative"]))
        if kind == "degenerate":
            x2, y2 = x1 + draw(st.integers(0, 1)), y1
        elif kind == "negative":
            x2, y2 = x1 - draw(st.integers(1, 30)), y1 - draw(st.integers(1, 30))
        else:
            x2, y2 = draw(_coord(w)), draw(_coord(h))
        boxes.append([x1 + draw(st.floats(0, 0.99)), y1, x2, y2 + draw(st.floats(0, 0.99))])
    classes = np.array([draw(st.integers(0, 20)) for _ in range(n)], np.int64)  # past the palette of 8
    scores = np.array([draw(st.floats(0, 1)) for _ in range(n)], np.float32)
    seed = draw(st.integers(0, 2 ** 16))
    return h, w, np.array(boxes, np.float64).reshape(-1, 4), classes, scores, seed


@CASES
@given(boxes2d_case(), st.sampled_from(["none", "names", "scores", "both"]))
def test_draw_boxes2d(case, labels):
    """Boxes inside, partly and wholly off the canvas, negative and
    degenerate, class ids past the palette, with and without class-name and
    score labels."""
    h, w, boxes, classes, scores, seed = case
    img = _canvas(np.random.RandomState(seed), h, w)
    names = [f"cls{i}{PRINTABLE[(7 * i) % 95]}" for i in range(21)] if labels in ("names", "both") else None
    sc = scores if labels in ("scores", "both") else None
    want = jdraw.draw_boxes2d(img, boxes, classes, sc, class_names=names)
    got = pdraw.draw_boxes2d(img, boxes, classes, sc, class_names=names)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdraw.draw_boxes2d(img, boxes), jdraw.draw_boxes2d(img, boxes))


def _quats(draw, n):
    q = np.array([[draw(st.floats(-1, 1)) for _ in range(4)] for _ in range(n)], np.float64).reshape(n, 4)
    q[:, 0] += 1.5  # away from the zero quaternion
    return q


KITTI_K = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]])


@st.composite
def boxes3d_case(draw):
    n = draw(st.integers(0, 6))
    quat = _quats(draw, n)
    tvec = np.array([[draw(st.floats(-30, 30)), draw(st.floats(-3, 3)), draw(st.floats(-4, 70))]
                     for _ in range(n)], np.float64).reshape(n, 3)  # some behind the camera or across z = 0.1
    size = np.array([[draw(st.floats(0.3, 3)), draw(st.floats(0.3, 12)), draw(st.floats(0.5, 4))]
                     for _ in range(n)], np.float64).reshape(n, 3)
    classes = np.array([draw(st.integers(0, 12)) for _ in range(n)], np.int64)
    scale = draw(st.sampled_from([0.1, 0.25]))
    return quat, tvec, size, classes, scale, draw(st.integers(0, 2 ** 16))


@CASES
@given(boxes3d_case())
def test_draw_boxes3d(case):
    """Projected wireframes at KITTI intrinsics scaled to a small canvas,
    boxes in front of, across and behind the camera."""
    quat, tvec, size, classes, scale, seed = case
    k = KITTI_K * np.array([[scale], [scale], [1.0]])
    img = _canvas(np.random.RandomState(seed), int(375 * scale), int(1242 * scale))
    want = jdraw.draw_boxes3d(img, quat, tvec, size, k, classes)
    np.testing.assert_array_equal(pdraw.draw_boxes3d(img, quat, tvec, size, k, classes), want)


@settings(max_examples=25, derandomize=True, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 6), st.integers(0, 2 ** 16))
def test_bev_image(n, seed):
    """BEV boxes at all angles (yaw over the whole circle and tilted
    quaternions), near the ego, far and off the 100 m canvas."""
    rng = np.random.RandomState(seed)
    yaw = rng.uniform(-np.pi, np.pi, n)
    quat = np.stack([np.cos(yaw / 2), rng.normal(0, 0.1, n), np.sin(yaw / 2), rng.normal(0, 0.1, n)], axis=1)
    tvec = np.stack([rng.uniform(-60, 60, n), rng.uniform(-2, 2, n), rng.uniform(-5, 110, n)], axis=1)
    size = rng.uniform(0.3, 15, (n, 3))
    classes = rng.randint(0, 12, n)
    want = jdraw.BEVImage().render_boxes3d(quat, tvec, size, classes).data
    got = pdraw.BEVImage().render_boxes3d(quat, tvec, size, classes).data
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdraw.BEVImage().data, jdraw.BEVImage().data)


def test_mosaic():
    rng = np.random.RandomState(0)
    images = [_canvas(rng, h, w) for h, w in ((10, 20), (31, 7), (5, 5), (16, 16), (8, 40))]
    for k in range(len(images) + 1):
        for cols in (None, 1, 2, 3):
            np.testing.assert_array_equal(pdraw.mosaic(images[:k], grid_cols=cols),
                                          jdraw.mosaic(images[:k], grid_cols=cols))


def test_save_vis_roundtrip(tmp_path):
    """The port's PNG, decoded by the port's reader, equals cv2.imread of
    the JAX package's file of the same drawing; both get the same name."""
    from dd3d_tpu_torch.data.imageio import read_image_bgr

    rng = np.random.RandomState(1)
    img = pdraw.draw_boxes2d(_canvas(rng, 57, 83), np.array([[3.5, 12, 70, 50]]), np.array([2]), np.array([0.87]),
                             class_names=["Car", "Pedestrian", "Cyclist"])
    want_path = jdraw.save_vis(img, str(tmp_path / "jax"), "frame_0001")
    got_path = pdraw.save_vis(img, str(tmp_path / "port"), "frame_0001")
    assert os.path.basename(got_path) == os.path.basename(want_path) == "frame_0001.png"
    assert pdraw.save_vis(img, str(tmp_path / "port"), "x.png").endswith("/x.png")
    np.testing.assert_array_equal(read_image_bgr(got_path), cv2.imread(want_path))
    np.testing.assert_array_equal(read_image_bgr(got_path), img)


def _kitti_sample(rng, h=96, w=320, n=5):
    """A mapper-like sample: image, intrinsics, 2D boxes, classes and the
    10-vector 3D ground truth (quat, projected center, depth, size)."""
    k = (KITTI_K * np.array([[w / 1242], [h / 375], [1.0]])).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n)
    quat = np.stack([np.cos(yaw / 2), np.zeros(n), np.sin(yaw / 2), np.zeros(n)], axis=1)
    tvec = np.stack([rng.uniform(-15, 15, n), rng.uniform(0.5, 2, n), rng.uniform(4, 50, n)], axis=1)
    uvw = tvec @ k.T.astype(np.float64)
    proj = uvw[:, :2] / uvw[:, 2:]
    size = rng.uniform(0.5, 4, (n, 3))
    x1, y1 = rng.uniform(-20, w, n), rng.uniform(-10, h, n)
    boxes2d = np.stack([x1, y1, x1 + rng.uniform(2, 90, n), y1 + rng.uniform(2, 50, n)], axis=1).astype(np.float32)
    return {"image": _canvas(rng, h, w), "intrinsics": k, "gt_boxes2d": boxes2d,
            "gt_classes": rng.randint(0, 5, n).astype(np.int32),
            "gt_boxes3d": np.concatenate([quat, proj, tvec[:, 2:], size], axis=1).astype(np.float32)}


@pytest.mark.parametrize("name", ["d2_visualizer", "box3d_visualizer"])
def test_dataloader_visualizers(name):
    from dd3d_tpu.data.catalog import MetadataCatalog as JaxMetadata
    from dd3d_tpu.visualizers import get_dataloader_visualizer as jax_get
    from dd3d_tpu_torch.data.catalog import MetadataCatalog
    from dd3d_tpu_torch.visualizers import get_dataloader_visualizer

    names = ["Car", "Pedestrian", "Cyclist", "Van", "Truck"]
    JaxMetadata.get("vis_test")["thing_classes"] = MetadataCatalog.get("vis_test")["thing_classes"] = names
    rng = np.random.RandomState(3)
    for _ in range(3):
        sample = _kitti_sample(rng)
        want = jax_get(None, name, "vis_test").visualize(sample)
        np.testing.assert_array_equal(get_dataloader_visualizer(None, name, "vis_test").visualize(sample), want)
    with pytest.raises(KeyError):
        get_dataloader_visualizer(None, "nope", "vis_test")


@pytest.mark.parametrize("name", ["d2_visualizer", "box3d_visualizer"])
def test_prediction_visualizers(name):
    """Per-image detections (the fields unpack_detections gives), kept at
    score >= 0.3 by the visualizer."""
    from dd3d_tpu.data.catalog import MetadataCatalog as JaxMetadata
    from dd3d_tpu.visualizers import get_predictions_visualizer as jax_get
    from dd3d_tpu_torch.data.catalog import MetadataCatalog
    from dd3d_tpu_torch.visualizers import get_predictions_visualizer

    names = ["Car", "Pedestrian", "Cyclist", "Van", "Truck"]
    JaxMetadata.get("vis_test")["thing_classes"] = MetadataCatalog.get("vis_test")["thing_classes"] = names
    rng = np.random.RandomState(4)
    for _ in range(3):
        s = _kitti_sample(rng, n=8)
        g = s["gt_boxes3d"].astype(np.float64)
        rays = np.concatenate([g[:, 4:6], np.ones((8, 1))], axis=1) @ np.linalg.inv(s["intrinsics"]).T
        det = {"classes": s["gt_classes"], "scores": rng.uniform(0, 1, 8).astype(np.float32),
               "scores_3d": rng.uniform(0, 1, 8).astype(np.float32), "boxes2d": s["gt_boxes2d"],
               "quat": g[:, :4], "tvec": rays * g[:, 6:7], "size": g[:, 7:]}
        args = (s["image"], det) + ((s["intrinsics"],) if name == "box3d_visualizer" else ())
        want = jax_get(None, name, "vis_test", "/unused").visualize(*args)
        got = get_predictions_visualizer(None, name, "vis_test", "/unused").visualize(*args)
        np.testing.assert_array_equal(got, want)

if __name__ == "__main__":
    write_font_module()
    print(f"wrote {FONT_MODULE}")
