"""The port's rasterizer: numpy versions of the OpenCV 5.0 drawing calls that
dd3d_tpu/visualizers/draw.py makes, equal to them pixel for pixel on
(H, W, 3) uint8 images.

- `line(img, p0, p1, color, 2)`, `rectangle(..., 2)` and closed
  `polylines(..., 2)`: OpenCV's ThickLine at shift 0 with the default LINE_8
  connectivity. A segment is a convex quadrilateral in 16.16 fixed point
  (its half-width rounded with cvRound, half to even), filled scanline by
  scanline (FillConvexPoly) after its edges are drawn by the fixed-point
  line walker (Line2, clipped to the image by clipLine in fixed point), and
  capped by filled radius-1 circles (both ends for `line`, the end of each
  segment for polylines and rectangles). Before that, OpenCV 5.0 clips the
  segment in whole pixels to the image grown by the thickness on each side,
  so the quadrilateral of a segment that leaves the image is that of its
  clipped part.
- `circle(img, center, r, color, -1)`: OpenCV's midpoint Circle, filled by
  horizontal spans.
- `box_points(center, size, angle)`: cv2.boxPoints, in float32 as
  RotatedRect::points computes it.
- `put_text(img, text, org, color)`: cv2.putText with FONT_HERSHEY_SIMPLEX at
  scale 0.5, thickness 1, the only text call of the drawing code. OpenCV 5.0
  renders it with its built-in outline font, anti-aliased: each glyph is a
  fixed coverage bitmap at an integer pen position (advances are whole pixels
  at this size, with no kerning), blended into the image glyph after glyph as
  (dst * (255 - a) + color * a + 127) // 255 per channel. The bitmaps and
  advances are recovered from cv2's own rendering (visualizers/font_simplex.py).
  A text whose origin lies right of the image draws nothing.

Coordinates are Python ints; an image is modified in place, like cv2's.
"""
import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cv_round(v: float) -> int:
    """cvRound of a double: nearest, ties to even (SSE2 cvtsd2si)."""
    return int(np.rint(v))


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine on int64 points against [0, width-1] x [0,
    height-1]: the clipped points, or None when the segment misses."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _line2(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """OpenCV's Line2: an 8-connected line between two 16.16 fixed-point
    points, clipped in fixed point first."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += HALF
    y1 += HALF
    _put_points(img, np.array([(x2 + HALF) >> XY_SHIFT]), np.array([(y2 + HALF) >> XY_SHIFT]), color)
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    _put_points(img, xs, ys, color)


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color) -> None:
    """OpenCV's FillConvexPoly for 16.16 fixed-point vertices (shift
    XY_SHIFT, LINE_8): the outline by Line2, then the spans between the
    two edge walkers, each edge's x stepped by a rounded per-row slope."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx_ = [imin, imin]
    di = [1, npts - 1]
    ye = [ymin, ymin]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx_[i]
                idx = idx0 + di[i]
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx += di[i]
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y < 0:
            # rows above the image only step the edges: jump to the next
            # edge change or row 0, whichever comes first (exact: x moves
            # by a whole dx a row)
            n = min(ye[0], ye[1], 0, ymax + 1) - y
            if n > 1:
                ex[0] += (n - 1) * edx[0]
                ex[1] += (n - 1) * edx[1]
                y += n - 1
        else:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + delta) >> XY_SHIFT
            xx2 = (ex[right] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center: Tuple[int, int], radius: int, color, thickness: int = -1) -> np.ndarray:
    """cv2.circle, filled (thickness -1), LINE_8, shift 0: OpenCV's
    midpoint Circle with horizontal spans."""
    if thickness >= 0:
        raise NotImplementedError("only the filled circle (thickness -1) is ported")
    _fill_circle(img, int(center[0]), int(center[1]), int(radius), color)
    return img


def _fill_circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color, thickness: int,
                flags: int) -> None:
    """OpenCV's ThickLine for integer points (shift 0), thickness > 1,
    LINE_8; `flags` bit 0 caps p0 and bit 1 caps p1."""
    if thickness <= 1:
        raise NotImplementedError("only thick lines (thickness > 1) are ported")
    h, w = img.shape[:2]
    m = thickness  # the segment is first clipped, in whole pixels, to the image grown by the thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, int(p0[0]) + m, int(p0[1]) + m, int(p1[0]) + m, int(p1[1]) + m)
    if clipped is None:
        return
    p0 = ((clipped[0] - m) << XY_SHIFT, (clipped[1] - m) << XY_SHIFT)
    p1 = ((clipped[2] - m) << XY_SHIFT, (clipped[3] - m) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _cv_round(dy * r), _cv_round(dx * r)
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, color)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _fill_circle(img, (p[0] + HALF) >> XY_SHIFT, (p[1] + HALF) >> XY_SHIFT, (thickness + HALF) >> XY_SHIFT,
                         color)


def line(img: np.ndarray, pt1, pt2, color, thickness: int) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness) for thickness > 1."""
    _thick_line(img, pt1, pt2, color, thickness, 3)
    return img


def polylines(img: np.ndarray, pts: np.ndarray, is_closed: bool, color, thickness: int) -> np.ndarray:
    """cv2.polylines(img, [pts], is_closed, color, thickness) for one
    (N, 2) int polygon and thickness > 1."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not pts:
        return img
    i = len(pts) - 1 if is_closed else 0
    flags = 2 + (not is_closed)
    p0 = pts[i]
    for p in pts[(not is_closed):]:
        _thick_line(img, p0, p, color, thickness, flags)
        p0 = p
        flags = 2
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness) for thickness > 1: the
    closed outline pt1, (x2, y1), pt2, (x1, y2)."""
    (x1, y1), (x2, y2) = pt1, pt2
    return polylines(img, np.array([(x1, y1), (x2, y1), (x2, y2), (x1, y2)], np.int64), True, color, thickness)


def box_points(center, size, angle) -> np.ndarray:
    """cv2.boxPoints(((cx, cy), (w, h), angle)): the (4, 2) float32 corners,
    each computed from the center in float32 as OpenCV 5.0's
    RotatedRect::points does (cos and sin of the angle in double, cast to
    float; the third and fourth corner by their own sums, not as the
    reflections of the first two)."""
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (cx + a * h + b * w, cy - b * h + a * w)
    p3 = (cx - a * h + b * w, cy + b * h + a * w)
    return np.array([p0, p1, p2, p3], np.float32)


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1):
    each glyph's coverage blended in turn at its integer pen position."""
    from dd3d_tpu_torch.visualizers.font_simplex import glyphs

    table = glyphs()
    h, w = img.shape[:2]
    if int(org[0]) >= w:
        return img  # cv2 draws nothing from an origin right of the image (a 'j' would reach back into it)
    col = np.asarray(color, np.int32).reshape(-1)
    col = col[: img.shape[2]] if img.ndim == 3 else col[0]
    x = int(org[0])
    y0 = int(org[1])
    for ch in text:
        if ch not in table:
            raise ValueError(f"put_text: no glyph for {ch!r} (printable ASCII only)")
        adv, ox, oy, cov = table[ch]
        gh, gw = cov.shape
        top, left = y0 + oy, x + ox
        r0, r1 = max(top, 0), min(top + gh, h)
        c0, c1 = max(left, 0), min(left + gw, w)
        if r0 < r1 and c0 < c1:
            a = cov[r0 - top:r1 - top, c0 - left:c1 - left].astype(np.int32)
            a = a[..., None] if img.ndim == 3 else a
            dst = img[r0:r1, c0:c1].astype(np.int32)
            img[r0:r1, c0:c1] = ((dst * (255 - a) + col * a + 127) // 255).astype(np.uint8)
        x += adv
    return img
